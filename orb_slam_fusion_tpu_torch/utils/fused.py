"""Sums of squares rounded as XLA:CPU compiles the reference's.

Inside a jitted program XLA:CPU contracts ``jnp.sum(x ** 2, axis=-1)`` over
a short axis into a chain of fused multiply-adds: ``fma(x1, x1, x0 * x0)``
for two terms, one more fused step per further term. Eager PyTorch rounds
each square and each add. Where such a sum meets a threshold (a pixel
window, a chi-square gate), the two roundings can fall on either side of
it, so the port's gates use ``sum_sq_f32`` (ROADMAP C11).
"""

from __future__ import annotations

import torch


def sq_add_f32(x: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """float32 ``x * x + acc`` rounded once, as a fused multiply-add: the
    exact square (float64 holds it) plus ``acc``, TwoSum for the error of
    the float64 sum, which decides the one case float64 cannot, a sum
    exactly halfway between two float32 values."""
    a = x.double() * x.double()
    b = acc.double()
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    r = s.float()
    up = torch.nextafter(r, torch.full_like(r, float("inf")))
    dn = torch.nextafter(r, torch.full_like(r, float("-inf")))
    r = torch.where(((r.double() + up.double()) * 0.5 == s) & (e > 0), up, r)
    return torch.where(((r.double() + dn.double()) * 0.5 == s) & (e < 0), dn,
                       r)


def within_fused(du: torch.Tensor, dv: torch.Tensor, r2: torch.Tensor
                 ) -> torch.Tensor:
    """``fma(dv, dv, du*du) <= r2``, the window test of the reference's
    jitted programs. The term-by-term sum differs from it by an ulp or two,
    so only the pairs within 1e-6 of the edge are decided by the fused
    value, the rest as they are."""
    d2 = du * du + dv * dv
    ok = d2 <= r2
    near = (d2 <= r2 * (1.0 + 1e-6) + 1e-30) & \
        (d2 >= r2 * (1.0 - 1e-6) - 1e-30)
    i = torch.nonzero(near, as_tuple=True)
    r2 = r2.expand_as(d2)
    return ok.index_put(i, sq_add_f32(dv[i], du[i] * du[i]) <= r2[i])


def sum_sq_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``sum(x ** 2, dim=-1)`` as XLA:CPU fuses it: the first
    square rounded, then one fused multiply-add per further element."""
    out = x[..., 0] * x[..., 0]
    for i in range(1, x.shape[-1]):
        out = sq_add_f32(x[..., i], out)
    return out
