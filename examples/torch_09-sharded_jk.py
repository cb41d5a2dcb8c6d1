"""Task-sharded get_jk over torch.distributed ranks (counterpart of the
sharded half of __graft_entry__.py for joltqc_tpu_torch).

Every rank runs its slice of each launch; the exact int64 limb sums are
added with one all_reduce, so J/K equal one rank's to the bit.  On one
card the ranks share it under gloo (NCCL refuses two ranks on one
device); with a card per rank ``task_group`` picks nccl.

  PYTHONPATH=. torchrun --nproc-per-node 2 examples/torch_09-sharded_jk.py
  PYTHONPATH=. torchrun --nproc-per-node 2 examples/torch_09-sharded_jk.py \
      --device cpu
"""

import argparse
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from joltqc_tpu_torch.mol import Molecule
from joltqc_tpu_torch.mol.layout import BasisLayout
from joltqc_tpu_torch.parallel import (
    rank_device, sharded_jk_engine, task_group,
)
from joltqc_tpu_torch.scf import JKEngine

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default=None, help="cuda (default) or cpu")
ap.add_argument("--basis", default="6-31g")
args = ap.parse_args()

group = task_group(
    "gloo" if args.device == "cpu"
    or torch.cuda.device_count() < int(os.environ["WORLD_SIZE"]) else None)
dev = rank_device(group, args.device)
rank = dist.get_rank(group)
mol = Molecule.from_atom_string(
    "O 0 0 0.1174; H -0.757 0 -0.4696; H 0.757 0 -0.4696; "
    "O 3 0 0.1174; H 2.243 0 -0.4696; H 3.757 0 -0.4696", basis=args.basis)
layout = BasisLayout(mol)
a = np.random.default_rng(0).uniform(-1, 1, (mol.nao, mol.nao))
dm = a + a.T

eng = sharded_jk_engine(layout, group, device=dev)
vj, vk = eng.get_jk(dm)
vj_1, vk_1 = JKEngine(layout, device=dev).get_jk(dm)
same = np.array_equal(vj, vj_1) and np.array_equal(vk, vk_1)
print(f"rank {rank} on {dev}: {eng.plan_stats['rank_tasks']} of "
      f"{eng.plan_stats['ntasks']} tasks, reduce {eng.timing['reduce_s']:.4f}"
      f" s of {eng.timing['reduce_bytes']} B; bit-identical to one rank: "
      f"{same}", flush=True)
dist.destroy_process_group()
sys.exit(0 if same else 1)
