"""The port covers the JAX package's public surface.

For every ``joltqc_tpu/**.py``, each public top-level function and class,
and each public method of a public class, must be defined in the port's
module of the same path (``joltqc_tpu_torch/**.py``), or stand in
``ALLOWED`` with its reason.  Read with ``ast`` only: nothing is
imported.  An entry of ``ALLOWED`` that the port now defines, or that the
reference no longer has, fails too, so the list stays exact.
"""

import ast
import pathlib

ROOT = pathlib.Path(__file__).resolve().parent.parent
REF, PORT = ROOT / "joltqc_tpu", ROOT / "joltqc_tpu_torch"

# "module" or "module::name" -> why the port has no such name
_DF64 = "DF64 (double-float32) arithmetic: the card has native float64"
ALLOWED = {
    "ops/df64.py": _DF64,
    "ops/arith.py": "the DF64/F32 arithmetic switch: torch dtypes do it",
    "ops/eri_pallas.py": "a Pallas kernel: kernel A in csrc/eri.cuh",
    "ops/accum_pallas.py": "a Pallas kernel: kernel D in csrc/accum_block.cu",
    "utils/cache.py": "JAX's compile cache: ops/cuda.py caches the builds",
    "parallel/jk_sharded.py::task_mesh": "a jax Mesh: task_group gives a "
                                         "torch.distributed group",
    "ops/bessel.py::ine_df64": _DF64 + " (ine)",
    "ops/boys.py::boys_df64": _DF64 + " (boys)",
    "ops/boys.py::boys_f32": "boys takes float32 tensors as they are",
    "ops/accum.py::limbs_to_df64": _DF64 + " (limbs_to_f64)",
    "ops/accum_tile.py::tile_limbs_to_df64": _DF64 + " (limbs_to_f64)",
    "ops/accum_tile.py::dm_rows_t": "the Pallas tile kernel's padded dm "
                                    "rows: kernel B gathers its own",
    "ops/md.py::make_pair_data_c": "scalarised for Pallas: make_pair_data",
    "ops/md.py::make_pair_data_s": "scalarised for Pallas: make_pair_data",
    "ops/md.py::eri_scalar_g_rows": "scalarised for Pallas: "
                                    "cart_eri_primitive",
    "ops/md.py::stack_e_pairs": "E rows over tri_set: e_rows",
    "ops/md.py::e_scalar": "scalarised for Pallas: e_table",
    "ops/md.py::e_tensor": "the stacked E tensor: e_table",
    "ops/md.py::r_scalar": "scalarised for Pallas: r_table",
    "ops/md.py::r_tensor_stacked": "the stacked R tensor: r_table",
    "ops/md.py::cart_eri_primitive_s": "scalarised for Pallas: "
                                       "cart_eri_primitive",
    "ops/md.py::comp_pair_maps": "component-pair maps: e_gather_index",
    "ops/md.py::box_tri_index": "tri_set indices in the Pallas box: "
                                "r_recurrence_tables",
}


def _public(path):
    """Public top-level functions and classes, and public methods of
    public classes (as "Class.method"), of one source file."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)) or node.name[0] == "_":
            continue
        out.add(node.name)
        if isinstance(node, ast.ClassDef):
            out.update(f"{node.name}.{m.name}" for m in node.body
                       if isinstance(m, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))
                       and m.name[0] != "_")
    return out


def test_port_covers_reference_surface():
    missing, used = [], set()
    for ref in sorted(REF.rglob("*.py")):
        rel = ref.relative_to(REF).as_posix()
        if rel in ALLOWED:
            used.add(rel)
            continue
        port = PORT / rel
        have = _public(port) if port.exists() else set()
        for name in sorted(_public(ref) - have):
            key = f"{rel}::{name}"
            (used.add if key in ALLOWED else missing.append)(key)
    assert not missing, f"not in the port and not allowed: {missing}"
    stale = sorted(set(ALLOWED) - used)
    assert not stale, f"allowed but not missing: {stale}"
