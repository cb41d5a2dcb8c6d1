"""VV10 nonlocal correlation (Vydrov & Van Voorhis 2010).

Port of ``joltqc_tpu/dft/vv10.py``.  The energy is the JAX package's, in
float32, a double sum over grid points blocked along the inner index:

  E = sum_i w_i rho_i [ beta + 0.5 sum_j w_j rho_j Phi_ij ]
  Phi_ij = -1.5 / (g_i g_j (g_i + g_j)),   g_i = omega0_i R_ij^2 + kappa_i
  omega0 = sqrt(C (sigma/rho^2)^2 + (4 pi/3) rho)
  kappa  = b (3 pi/2) (rho / (9 pi))^(1/6)
  beta   = (1/32) (3 / b^2)^(3/4)

and the potentials are its gradient with respect to rho and sigma, with
the quadrature weights divided out.  The JAX package differentiates the
blocked loop with ``jax.value_and_grad``; plain torch autograd would keep
every (N, block) tile of the loop for the backward pass, O(N^2) memory.
So the pair sum P = sum_ij wr_i wr_j Phi_ij is a ``torch.autograd.Function``
(``_PairSum``) whose forward accumulates U_i = sum_j Phi_ij wr_j block by
block and whose backward recomputes each block's Phi and its derivative
with respect to g_i: memory O(N * block).  Phi is symmetric in (i, j), so
the derivative through g_j equals the one through g_i with the indices
swapped, and the backward sums the g_i side over all j and doubles it.
The pointwise steps around it (omega0, kappa, wr from rho and sigma) are
plain autograd.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.cuda import resolve_device

_RHO_THRESH = 1e-8


def _pair_block(ci, oi, ki, cj, oj, kj):
    """R2, Phi, g_i and g_j (N, Bj) of all points i against one block j."""
    R2 = torch.sum((ci[:, None, :] - cj[None, :, :]) ** 2, dim=-1)
    gi = oi[:, None] * R2 + ki[:, None]
    gj = oj[None, :] * R2 + kj[None, :]
    phi = -1.5 / (gi * gj * (gi + gj))
    return R2, phi, gi, gj


class _PairSum(torch.autograd.Function):
    """P = sum_ij wr_i wr_j Phi_ij(omega0, kappa, coords); differentiable
    in omega0, kappa and wr, blocked along j in forward and backward."""

    @staticmethod
    def forward(ctx, omega0, kappa, wr, coords, block):
        U = torch.zeros_like(wr)
        for j0 in range(0, len(wr), block):
            j = slice(j0, j0 + block)
            _, phi, _, _ = _pair_block(coords, omega0, kappa,
                                       coords[j], omega0[j], kappa[j])
            U = U + phi @ wr[j]
        ctx.save_for_backward(omega0, kappa, wr, coords, U)
        ctx.block = block
        return torch.sum(wr * U)

    @staticmethod
    def backward(ctx, grad):
        omega0, kappa, wr, coords, U = ctx.saved_tensors
        A = torch.zeros_like(wr)  # sum_j dPhi_ij/dg_i R2_ij wr_j
        K = torch.zeros_like(wr)  # sum_j dPhi_ij/dg_i wr_j
        for j0 in range(0, len(wr), ctx.block):
            j = slice(j0, j0 + ctx.block)
            R2, phi, gi, gj = _pair_block(coords, omega0, kappa,
                                          coords[j], omega0[j], kappa[j])
            dphi = -phi * (2.0 * gi + gj) / (gi * (gi + gj))
            A = A + (dphi * R2) @ wr[j]
            K = K + dphi @ wr[j]
        # both indices of the symmetric Phi: twice the g_i side
        return (grad * 2.0 * wr * A, grad * 2.0 * wr * K, grad * 2.0 * U,
                None, None)


def _vv10_energy(rho, sigma, coords, w, mask, b, C, block):
    """VV10 energy of the points under ``mask`` (autograd in rho, sigma)."""
    beta = (1.0 / 32.0) * (3.0 / (b * b)) ** 0.75
    rho_s = torch.where(mask, rho, 1.0)
    sig_s = torch.where(mask, sigma, 0.0)
    w_eff = torch.where(mask, w, 0.0)
    omega0 = torch.sqrt(
        C * (sig_s / rho_s**2) ** 2 + (4.0 * np.pi / 3.0) * rho_s
    )
    kappa = b * 1.5 * np.pi * (rho_s / (9.0 * np.pi)) ** (1.0 / 6.0)
    wr = w_eff * rho_s
    return beta * torch.sum(wr) + 0.5 * _PairSum.apply(
        omega0, kappa, wr, coords, block)


def nlc_exc_vxc(coords, weights, rho, sigma, b: float = 5.9, C: float = 0.0093,
                block: int = 2048, device=None):
    """VV10 energy + potentials on the (padded) molecular grid.

    coords (N,3), weights/rho/sigma (N,) numpy.  Runs in float32 on
    ``device`` (``cuda`` unless the caller names another).  Returns
    (e_nlc, vrho, vsigma) with the quadrature weights DIVIDED OUT of the
    gradients, so the potentials follow the same unweighted convention as
    ``dft.xc.eval_xc`` (the RKS driver multiplies by w once).
    """
    dev = resolve_device(device)
    N = len(weights)
    if N % block:
        pad = (-N) % block
        coords = np.concatenate([coords, np.zeros((pad, 3))])
        weights = np.concatenate([weights, np.zeros(pad)])
        rho = np.concatenate([rho, np.zeros(pad)])
        sigma = np.concatenate([sigma, np.zeros(pad)])
    mask = (rho > _RHO_THRESH) & (weights != 0)

    def f32(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)

    r = f32(rho).requires_grad_(True)
    s = f32(sigma).requires_grad_(True)
    with torch.enable_grad():
        e = _vv10_energy(r, s, f32(coords), f32(weights),
                         torch.as_tensor(mask, device=dev), float(b),
                         float(C), block)
        vr, vs = torch.autograd.grad(e, (r, s))
    w_safe = np.where(mask, weights, 1.0)
    vr = np.where(mask, vr.cpu().double().numpy() / w_safe, 0.0)[:N]
    vs = np.where(mask, vs.cpu().double().numpy() / w_safe, 0.0)[:N]
    return float(e.detach()), vr, vs


def nlc_exc_vxc_np(coords, weights, rho, sigma, b=5.9, C=0.0093):
    """f64 numpy oracle (energy only + FD-checkable potentials by tests)."""
    mask = (rho > _RHO_THRESH) & (weights != 0)
    r = rho[mask]
    s = sigma[mask]
    w = weights[mask]
    c = coords[mask]
    beta = (1.0 / 32.0) * (3.0 / (b * b)) ** 0.75
    omega0 = np.sqrt(C * (s / r**2) ** 2 + (4 * np.pi / 3) * r)
    kappa = b * 1.5 * np.pi * (r / (9 * np.pi)) ** (1.0 / 6.0)
    R2 = ((c[:, None, :] - c[None, :, :]) ** 2).sum(-1)
    gi = omega0[:, None] * R2 + kappa[:, None]
    gj = omega0[None, :] * R2 + kappa[None, :]
    phi = -1.5 / (gi * gj * (gi + gj))
    U = phi @ (w * r)
    return float(np.sum(w * r * (beta + 0.5 * U)))


__all__ = ["nlc_exc_vxc", "nlc_exc_vxc_np"]
