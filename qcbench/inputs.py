"""The general generator: a cell's inputs from its configuration, its
traffic mix and the seed.

The molecule is the configuration's xyz file moved rigidly (a rotation
and a translation drawn from the seed, ``rigid_motion``), so every seed
keeps the physics and the work while every number changes.  The
density is the core-Hamiltonian guess of the moved molecule, made by the
reference's own integrals; the program and the reference get the same
coordinates and the same density."""

from __future__ import annotations

import itertools
import os
from dataclasses import dataclass

import numpy as np

from .reference.basis import BOHR, RefMolecule

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def max_rel(a, ref):
    """max |a - ref| over max |ref|."""
    return float(np.abs(a - ref).max() / np.abs(ref).max())


def read_xyz(path):
    """(symbols, coordinates in Angstrom) of an xyz file."""
    with open(path) as f:
        lines = f.read().splitlines()
    n = int(lines[0].split()[0])
    rows = [ln.split() for ln in lines[2:2 + n]]
    return [r[0] for r in rows], np.array([[float(x) for x in r[1:4]]
                                           for r in rows])


def rng_of(seed):
    """A numpy Generator for any whole-number seed, negative or beyond 64
    bits included."""
    return np.random.default_rng(np.random.SeedSequence(int(seed) % 2 ** 64))


def octahedral_rotations():
    """The 24 proper rotations that map the cube onto itself: signed
    permutation matrices of determinant +1."""
    out = []
    for perm in itertools.permutations(range(3)):
        for signs in itertools.product((1.0, -1.0), repeat=3):
            m = np.zeros((3, 3))
            m[range(3), perm] = signs
            if np.linalg.det(m) > 0:
                out.append(m)
    return out


def rigid_motion(seed, step, steps):
    """(R, t): one of the 24 octahedral rotations and a translation by
    ``step`` Bohr times whole numbers in [-steps, steps], drawn from the
    seed.  Every seed then gives the same work: the program's grids
    (octahedral Lebedev rules, boxes of a fixed lattice) and its screening
    (shell-block maxima of |D|, whose cartesian components such a
    rotation only permutes and negates) come out the same up to order,
    while every coordinate and matrix element changes."""
    rng = rng_of(seed)
    rots = octahedral_rotations()
    R = rots[int(rng.integers(len(rots)))]
    return R, step * rng.integers(-steps, steps + 1, 3).astype(float)


@dataclass
class Inputs:
    symbols: list
    coords_bohr: np.ndarray
    basis: str
    ref_mol: RefMolecule
    dm: np.ndarray

    def atom_string(self):
        return "\n".join(f"{s} {float(x)!r} {float(y)!r} {float(z)!r}"
                         for s, (x, y, z)
                         in zip(self.symbols, self.coords_bohr))


def make_inputs(config, traffic, seed, device):
    """The inputs of a mix whose ``density`` is ``core_guess`` and whose
    ``motion``, if any, is ``octahedral``; a mix that needs other inputs
    names a call kind that makes its own (``calls/__init__.py``)."""
    from .reference.int1e import core_guess_density

    symbols, ang = read_xyz(os.path.join(ROOT, config["molecule"]))
    bohr = ang / BOHR
    motion = traffic.get("motion")
    if motion:
        if motion["rotation"] != "octahedral":
            raise ValueError(f"unknown rotation {motion['rotation']!r}")
        R, t = rigid_motion(seed, float(motion["translate_step_bohr"]),
                            int(motion["translate_steps"]))
        bohr = bohr @ R.T + t
    mol = RefMolecule(symbols, bohr, config["basis"])
    if traffic["density"] != "core_guess":
        raise ValueError(f"unknown density {traffic['density']!r}")
    dm = core_guess_density(mol, device)
    return Inputs(symbols, bohr, config["basis"], mol, dm)
