"""Bundle adjustment with Schur elimination: local windows and global BA.

Counterpart of ``orb_slam_fusion_tpu/solver/ba.py``: a static-shape
problem (a keyframe window from ``make_window_problem``, or the general
layout of ``make_problem``), two-phase robust LM (Huber, then
chi-square re-mask and plain Gauss-Newton weights), landmark elimination
with closed-form 3x3 inverses, a dense Cholesky solve of the reduced
camera system and batched back-substitution.

The reference lays every landmark-axis intermediate out flat ((F, 18),
(M, 9), one (M, K*18) product) to fit the TPU's (8, 128) tiling. That is a
TPU layout choice; here the blocks keep their natural (..., 6, 3) shapes
and the reduced system is one (6K, 3M) x (3M, 6K) product. The costs and
the solution are the reference's; the float summation order is not.
A problem built with ``u_right``/``stereo_mask``/``bf`` carries the
reference's stereo factor (EdgeStereoSE3ProjectXYZ): a third residual row
u_R = u_L - bf/z on its stereo factors, held to the 3-dof chi-square
threshold (``_factor_chi2_th``); a monocular problem keeps two rows.
``make_problem`` builds the reference's general layout (each landmark's
factor rows in order, up to ``max_obs``), which the visual-inertial BA
(``solver/vi_ba.py``) and global BA solve: ``_lm_step`` with
``window_layout=False`` scatters its pose-axis sums by ``kf_idx``, and
``_lm_step_cg`` (``pose_stride > 0``) solves the reduced camera system
matrix-free by block-Jacobi preconditioned conjugate gradients, for the
window-contiguous layout of ``observation_triples`` over the whole map
(global BA at grown capacities, K = 512, M = 32,768).
``ChunkedLM`` runs the same two-phase solve resumably, a few iterations
per call, for the tracker's background local BA and the loop closer's
background global BA.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from .. import cameras, lie
from ..utils.fused import contract_f32, fma_f32, rsqrt_f32, window_sum_f32
from .robust import CHI2_2D, CHI2_3D, huber_rho, huber_weight


class BAProblem(NamedTuple):
    """Static-shape BA problem (K poses, M landmarks, F factors).

    lm_factor_idx/lm_factor_valid (M, K): the factor row of each landmark
    in each window row (the window layout has at most one).
    u_right (F,), stereo_mask (F,), bf (): the stereo extension (the
    observed right-image u of factors with stereo_mask set, and the
    baseline times fx); None for a monocular problem.
    """

    poses: lie.SE3
    points: torch.Tensor
    kf_idx: torch.Tensor
    mp_idx: torch.Tensor
    uv: torch.Tensor
    inv_sigma2: torch.Tensor
    valid: torch.Tensor
    fixed_pose: torch.Tensor
    fixed_point: torch.Tensor
    cam_params: torch.Tensor
    lm_factor_idx: torch.Tensor
    lm_factor_valid: torch.Tensor
    u_right: torch.Tensor = None
    stereo_mask: torch.Tensor = None
    bf: torch.Tensor = None


def inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 inverse (adjugate / determinant)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    det = torch.where(torch.abs(det) < 1e-18, torch.full_like(det, 1e-18),
                      det)
    adj = torch.stack([
        torch.stack([A11, A12, A13], dim=-1),
        torch.stack([A21, A22, A23], dim=-1),
        torch.stack([A31, A32, A33], dim=-1),
    ], dim=-2)
    return adj / det[..., None, None]


def window_landmark_groups(kf_idx: torch.Tensor, mp_idx: torch.Tensor,
                           valid: torch.Tensor, num_points: int,
                           window_size: int):
    """(lm_factor_idx (M, W), lm_factor_valid (M, W)): slot (landmark,
    window row) holds the largest valid factor row, as the reference's
    scatter-max does."""
    F = kf_idx.shape[0]
    dev = kf_idx.device
    enc = torch.where(valid, torch.arange(1, F + 1, dtype=torch.int32,
                                          device=dev),
                      torch.zeros(F, dtype=torch.int32, device=dev))
    flat = (mp_idx.long() * window_size + kf_idx.long())
    lm = torch.zeros(num_points * window_size, dtype=torch.int32, device=dev)
    lm = lm.scatter_reduce(0, flat, enc, reduce="amax").view(
        num_points, window_size)
    return torch.clamp(lm - 1, min=0), lm > 0


def build_landmark_groups(mp_idx: torch.Tensor, num_points: int,
                          max_obs: Optional[int] = None,
                          valid: Optional[torch.Tensor] = None):
    """Group factor rows by landmark, padded to a static width: (lm_factor_idx
    (M, O) int32, lm_factor_valid (M, O) bool), landmark m's valid factor
    rows in increasing order, at most ``max_obs`` of them (the reference's
    host loop, as a stable sort on the device). ``max_obs`` None takes the
    largest count (one host read)."""
    dev = mp_idx.device
    F = mp_idx.shape[0]
    if valid is None:
        valid = torch.ones(F, dtype=torch.bool, device=dev)
    key = torch.where(valid.to(torch.bool), mp_idx.long(),
                      torch.full((F,), num_points, dtype=torch.long,
                                 device=dev))
    if max_obs is None:
        counts = torch.bincount(key, minlength=num_points + 1)[:num_points]
        max_obs = max(1, int(counts.max()) if num_points else 1)
    skey, order = torch.sort(key, stable=True)
    first = torch.searchsorted(skey, skey)
    rank = torch.arange(F, device=dev) - first
    keep = (skey < num_points) & (rank < max_obs)
    dump = num_points * max_obs
    flat = torch.where(keep, skey * max_obs + rank,
                       torch.full_like(skey, dump))
    idx = torch.zeros(dump + 1, dtype=torch.int32, device=dev).scatter(
        0, flat, order.to(torch.int32))
    mask = torch.zeros(dump + 1, dtype=torch.bool, device=dev).scatter(
        0, flat, keep)
    return (idx[:dump].view(num_points, max_obs),
            mask[:dump].view(num_points, max_obs))


def make_problem(poses: lie.SE3, points, kf_idx, mp_idx, uv, inv_sigma2,
                 valid, fixed_pose, cam_params, fixed_point=None,
                 max_obs: Optional[int] = None, u_right=None,
                 stereo_mask=None, bf=0.0) -> BAProblem:
    """BAProblem in the general layout (``build_landmark_groups``). As in
    the reference, the stereo fields are always set: zeros and an all-false
    mask unless given, so every factor has the third (zero) row."""
    dev = points.device
    lm_idx, lm_valid = build_landmark_groups(mp_idx, points.shape[0],
                                             max_obs, valid)
    F = kf_idx.shape[0]
    if fixed_point is None:
        fixed_point = torch.zeros(points.shape[0], dtype=torch.bool,
                                  device=dev)
    if u_right is None:
        u_right = torch.zeros(F, dtype=torch.float32, device=dev)
    if stereo_mask is None:
        stereo_mask = torch.zeros(F, dtype=torch.bool, device=dev)
    return BAProblem(
        poses=poses, points=points, kf_idx=kf_idx.to(torch.int32),
        mp_idx=mp_idx.to(torch.int32), uv=uv, inv_sigma2=inv_sigma2,
        valid=valid.to(torch.bool), fixed_pose=fixed_pose.to(torch.bool),
        fixed_point=fixed_point.to(torch.bool), cam_params=cam_params,
        lm_factor_idx=lm_idx, lm_factor_valid=lm_valid,
        u_right=u_right.to(torch.float32),
        stereo_mask=stereo_mask.to(torch.bool),
        bf=torch.tensor(float(bf), dtype=torch.float32, device=dev))


def make_window_problem(poses: lie.SE3, points, kf_idx, mp_idx, uv,
                        inv_sigma2, valid, fixed_pose, cam_params,
                        window_size: int, fixed_point=None, u_right=None,
                        stereo_mask=None, bf=0.0) -> BAProblem:
    """BAProblem for the ``observation_triples`` window layout; with
    ``u_right`` and ``stereo_mask`` it carries stereo factors."""
    lm_idx, lm_valid = window_landmark_groups(
        kf_idx, mp_idx, valid, points.shape[0], window_size)
    if fixed_point is None:
        fixed_point = torch.zeros(points.shape[0], dtype=torch.bool,
                                  device=points.device)
    stereo = {}
    if u_right is not None:
        stereo = dict(
            u_right=u_right.to(torch.float32),
            stereo_mask=stereo_mask.to(torch.bool),
            bf=torch.tensor(float(bf), dtype=torch.float32,
                            device=points.device))
    return BAProblem(
        poses=poses, points=points, kf_idx=kf_idx.to(torch.int32),
        mp_idx=mp_idx.to(torch.int32), uv=uv, inv_sigma2=inv_sigma2,
        valid=valid.to(torch.bool), fixed_pose=fixed_pose.to(torch.bool),
        fixed_point=fixed_point.to(torch.bool), cam_params=cam_params,
        lm_factor_idx=lm_idx, lm_factor_valid=lm_valid, **stereo)


def _transform(poses: lie.SE3, points: torch.Tensor, prob: BAProblem):
    kf = prob.kf_idx.long()
    Rk = poses.R[kf]
    Xw = points[prob.mp_idx.long()]
    return Rk, torch.matmul(Rk, Xw.unsqueeze(-1)).squeeze(-1) + poses.t[kf]


def _stereo_row(pred: torch.Tensor, pc: torch.Tensor, prob: BAProblem):
    """The right-image residual u_L - bf/z - u_R (0 on mono factors) and
    z, clamped as the reference clamps it."""
    z = torch.clamp(pc[..., 2], min=1e-6)
    r3 = torch.where(prob.stereo_mask, pred[..., 0] - prob.bf / z
                     - prob.u_right, torch.zeros_like(z))
    return r3, z


def _eval_residuals(poses: lie.SE3, points: torch.Tensor, prob: BAProblem,
                    cam_model: str):
    """Residuals (F,R) (zero where not finite) and the finite mask; R = 3
    for a stereo problem, else 2."""
    _, pc = _transform(poses, points, prob)
    pred = cameras.project(cam_model, prob.cam_params, pc)
    r = pred - prob.uv
    if prob.stereo_mask is not None:
        r = torch.cat([r, _stereo_row(pred, pc, prob)[0][..., None]], dim=-1)
    finite = (pc[..., 2] > 1e-4) & torch.isfinite(r).all(dim=-1)
    return torch.where(finite[..., None], r, torch.zeros_like(r)), finite


def _eval_factors(poses: lie.SE3, points: torch.Tensor, prob: BAProblem,
                  cam_model: str):
    """Residuals (F,R), J_pose (F,R,6), J_point (F,R,3), finite mask; the
    stereo row's Jacobian is d(u)/d(pc) + [0, 0, bf/z^2]."""
    Rk, pc = _transform(poses, points, prob)
    pred = cameras.project(cam_model, prob.cam_params, pc)
    r = pred - prob.uv
    Jproj = cameras.project_jac(cam_model, prob.cam_params, pc)
    if prob.stereo_mask is not None:
        r3, z = _stereo_row(pred, pc, prob)
        r = torch.cat([r, r3[..., None]], dim=-1)
        zero = torch.zeros_like(z)
        dur = Jproj[:, 0, :] + torch.stack([zero, zero, prob.bf / (z * z)],
                                           dim=-1)
        dur = torch.where(prob.stereo_mask[:, None], dur,
                          torch.zeros_like(dur))
        Jproj = torch.cat([Jproj, dur[:, None, :]], dim=1)
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(
        pc.shape[:-1] + (3, 3))
    J_pose = Jproj @ torch.cat([eye, -lie.hat(pc)], dim=-1)
    J_point = Jproj @ Rk
    finite = ((pc[..., 2] > 1e-4) & torch.isfinite(r).all(dim=-1)
              & torch.isfinite(J_pose).flatten(1).all(dim=-1)
              & torch.isfinite(J_point).flatten(1).all(dim=-1))
    z = torch.zeros((), dtype=r.dtype, device=r.device)
    return (torch.where(finite[..., None], r, z),
            torch.where(finite[..., None, None], J_pose, z),
            torch.where(finite[..., None, None], J_point, z), finite)


def _factor_chi2_th(prob: BAProblem, chi2_th: float):
    """Per-factor chi-square threshold: stereo factors are 3-dof (reference
    7.815 against 5.991, optimizer.cc:118,151); a float for a monocular
    problem."""
    if prob.stereo_mask is None:
        return chi2_th
    ratio = CHI2_3D / CHI2_2D
    return torch.where(prob.stereo_mask,
                       torch.tensor(chi2_th * ratio, dtype=torch.float32,
                                    device=prob.stereo_mask.device),
                       torch.tensor(chi2_th, dtype=torch.float32,
                                    device=prob.stereo_mask.device))


def _robust_cost(r, inv_sigma2, active, chi2_th):
    chi2 = torch.sum(r * r, dim=-1) * inv_sigma2
    return torch.sum(torch.where(active, huber_rho(chi2, chi2_th),
                                 torch.zeros_like(chi2))), chi2


def _lm_step(poses: lie.SE3, points: torch.Tensor, lam: torch.Tensor,
             inlier: torch.Tensor, prob: BAProblem, cam_model: str,
             chi2_th: float, use_robust: bool, window_layout: bool = False):
    """One damped LM step with Schur elimination. ``window_layout``: factor
    f belongs to window row f // (F/K) and landmark slot o is window row o
    (``make_window_problem``); otherwise the pose-axis sums scatter by
    ``kf_idx`` and each landmark's slots by the pose of their factor."""
    dtype, dev = points.dtype, points.device
    K = poses.t.shape[0]
    M = points.shape[0]
    F = prob.kf_idx.shape[0]
    if window_layout and (prob.lm_factor_idx.shape[1] != K or F % K):
        raise ValueError("window_layout needs make_window_problem's layout")

    r, Jp, Jl, depth_ok = _eval_factors(poses, points, prob, cam_model)
    active = prob.valid & inlier & depth_ok
    chi2 = torch.sum(r * r, dim=-1) * prob.inv_sigma2
    w_rob = (huber_weight(chi2, _factor_chi2_th(prob, chi2_th))
             if use_robust else torch.ones_like(chi2))
    w = torch.where(active, w_rob * prob.inv_sigma2, torch.zeros_like(chi2))

    Jpw = Jp * w[:, None, None]
    Jlw = Jl * w[:, None, None]
    gp_f = torch.einsum("fik,fi->fk", Jpw, r)                  # (F,6)
    gl_f = torch.einsum("fik,fi->fk", Jlw, r)                  # (F,3)
    Hpl_f = torch.einsum("fik,fil->fkl", Jpw, Jl)              # (F,6,3)
    Hll_f = torch.einsum("fik,fil->fkl", Jlw, Jl)              # (F,3,3)
    Hpp_f = torch.einsum("fik,fil->fkl", Jpw, Jp)              # (F,6,6)
    fidx = prob.lm_factor_idx.long()                           # (M,O)
    vmf = prob.lm_factor_valid
    zero = torch.zeros((), dtype=dtype, device=dev)
    Hll = torch.where(vmf[..., None, None], Hll_f[fidx], zero).sum(dim=1)
    gl = torch.where(vmf[..., None], gl_f[fidx], zero).sum(dim=1)
    GW = torch.where(vmf[..., None, None], Hpl_f[fidx], zero)  # (M,O,6,3)
    if window_layout:
        stride = F // K
        Hpp = Hpp_f.reshape(K, stride, 6, 6).sum(dim=1)        # (K,6,6)
        gp = gp_f.reshape(K, stride, 6).sum(dim=1)             # (K,6)
        W = GW                                 # slot o IS window row o
    else:
        # accumulating index_put_ sums in factor order on every device
        # (index_add_'s atomics on the card sum in any order, so two runs
        # would part)
        kf = prob.kf_idx.long()
        Hpp = torch.zeros((K, 6, 6), dtype=dtype, device=dev).index_put_(
            (kf,), Hpp_f, accumulate=True)
        gp = torch.zeros((K, 6), dtype=dtype, device=dev).index_put_(
            (kf,), gp_f, accumulate=True)
        pose_of = kf[torch.clamp(fidx, 0, F - 1)]              # (M,O)
        rows = torch.arange(M, device=dev)[:, None].expand_as(pose_of)
        W = torch.zeros((M, K, 6, 3), dtype=dtype, device=dev)
        W.index_put_((rows, pose_of), GW, accumulate=True)     # (M,K,6,3)

    eye3 = torch.eye(3, dtype=dtype, device=dev)
    Hll_d = Hll + lam * Hll * eye3 + 1e-8 * eye3
    fixl = prob.fixed_point
    Hll_d = torch.where(fixl[:, None, None], eye3, Hll_d)
    gl = torch.where(fixl[:, None], zero, gl)
    Hinv = torch.where(fixl[:, None, None], zero, inv3x3(Hll_d))

    # reduced camera system S = blockdiag(Hpp) - sum_m E_m W_m^T, E = W Hinv
    E = W @ Hinv[:, None]                                      # (M,K,6,3)
    E2 = E.permute(1, 2, 0, 3).reshape(K * 6, M * 3)
    W2 = W.permute(1, 2, 0, 3).reshape(K * 6, M * 3)
    S = torch.block_diag(*Hpp) - E2 @ W2.T                     # (6K,6K)
    g_r = gp - torch.einsum("mkpc,mc->kp", E, gl)              # (K,6)

    fp = prob.fixed_pose
    fpv = fp.repeat_interleave(6)
    S = torch.where(fpv[:, None] | fpv[None, :], zero, S)
    S = S + torch.diag(fpv.to(dtype))
    g_r = torch.where(fp[:, None], zero, g_r)
    S = S + torch.diag(lam * torch.diagonal(S) + 1e-8)
    # NaN where the Cholesky factorization fails, as the reference's
    # solve(assume_a="pos"): the accept test then rejects the step
    dx_p = -solve_pos(S, g_r.reshape(-1)).reshape(K, 6)
    dx_p = torch.where(fp[:, None], zero, dx_p)

    back = torch.einsum("mkpc,kp->mc", W, dx_p)                # (M,3)
    dx_l = (Hinv @ (-gl - back).unsqueeze(-1)).squeeze(-1)
    dx_l = torch.where(fixl[:, None], zero, dx_l)
    return lie.se3_boxplus(poses, dx_p), points + dx_l, active


def _flat_inv3x3(H9: torch.Tensor) -> torch.Tensor:
    """``inv3x3`` on (M, 9) row-major flattened blocks -> (M, 9) (the
    reference's TPU layout; the same products)."""
    return inv3x3(H9.reshape(-1, 3, 3)).reshape(-1, 9)


def solve_pos(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """x = H^-1 g for symmetric positive definite H (batched; g a vector or
    a matrix per H), factoring the lower triangle of H; NaN where the
    Cholesky factorization fails, as the reference's solves give. Of this
    function's callers, only the PCG preconditioner's blocks
    (``_lm_step_cg``) have a reference that reads the lower triangle
    (``cho_factor(lower=True)``). Every other reference call is
    ``jax.scipy.linalg.solve(assume_a="pos")``, whose ``cho_factor(lower=
    False)`` factors the transposed matrix and so reads the upper
    triangle: ``vi_ba._solve_upper`` follows it there; the other callers
    keep the lower one."""
    L, info = torch.linalg.cholesky_ex(H)
    vec = g.dim() == H.dim() - 1
    x = torch.cholesky_solve(g.unsqueeze(-1) if vec else g, L)
    x = x.squeeze(-1) if vec else x
    ok = (info == 0).reshape(info.shape + (1,) * (x.dim() - info.dim()))
    return torch.where(ok, x, torch.full_like(x, float("nan")))


# The PCG step below sums its float32 linearization in the order of the
# reference's compiled ``lm_chunk`` (XLA:CPU, read off its optimized HLO,
# LLVM IR and object code; ROADMAP C14b): each small dot a chain of fused
# multiply-adds from +0 (``contract_f32``), the column-major matrix-vector
# products from their first plain product (a -0 start), the landmark
# slots and the pose segments summed in order (``window_sum_f32``), the
# Huber weight through XLA's ``rsqrt`` (``rsqrt_f32``), the 3x3 inverses as
# ``_inv3x3_fused``. These functions serve the PCG step only: the dense
# ``_lm_step``, the VI-BA and the sharded BA keep their own order.


def _chain(x: torch.Tensor, y: torch.Tensor, plain_first: bool = False
           ) -> torch.Tensor:
    """``sum(x * y, -1)`` as one chain of fused steps: from +0, or from the
    first plain product (a column-major gemv's start)."""
    zero = torch.full((), -0.0 if plain_first else 0.0, dtype=x.dtype,
                      device=x.device)
    return contract_f32(x, y, zero)


def _slot_sum(G: torch.Tensor, vmf: torch.Tensor,
              from_zero: torch.Tensor) -> torch.Tensor:
    """``einsum("mo,mo...->m...", vmf, G)`` for a 0/1 ``vmf``, as the
    reference's column-major gemv sums the slots: in slot order, each
    product exact, from the first product (+0 added where ``from_zero``,
    the outputs in the kernel's whole vectors of eight)."""
    p = vmf.reshape(vmf.shape + (1,) * (G.dim() - 2)) * G
    acc = torch.where(from_zero, p[:, 0] + 0.0, p[:, 0])
    for o in range(1, G.shape[1]):
        acc = acc + p[:, o]
    return acc


def _inv3x3_fused(A: torch.Tensor) -> torch.Tensor:
    """``inv3x3`` as the reference's compiled PCG step rounds it: each
    cofactor ``fma(x, y, -(z w))``, the determinant ``fma(c, A31, fma(a,
    A11, b A21))``, then the adjugate over it. Bit for bit at the test's
    256 landmarks; at 32,768 the reference's program splits the landmarks
    among three workgroups, and the first two compute the (1,0) cofactor
    as ``fma(-d, i, f g)`` (not restated, ROADMAP C14b). The VI-BA's
    compile rounds otherwise at 8,192 points (C14c), so ``inv3x3`` keeps
    its rounding for its other callers."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    st = lambda *v: torch.stack(v, dim=-1)  # noqa: E731
    # the nine cofactors in row-major order of the adjugate
    C = fma_f32(st(e, c, b, f, a, c, d, b, a), st(i, h, f, g, i, d, h, g, e),
                -(st(f, b, c, d, c, a, e, a, b)
                  * st(h, i, e, i, g, f, g, h, d)))
    det = fma_f32(c, C[..., 6], fma_f32(a, C[..., 0], b * C[..., 3]))
    det = torch.where(torch.abs(det) < 1e-18, torch.full_like(det, 1e-18),
                      det)
    return (C / det[..., None]).reshape(A.shape)


def _pcg_factors(poses: lie.SE3, points: torch.Tensor, prob: BAProblem,
                 cam_model: str):
    """``_eval_factors`` rounded as the compiled PCG step rounds it, for
    the pinhole camera: ``pc`` a chain over ``R X`` plus ``t``, the pixel
    ``fma(fx x, 1/z, cx)``, ``J_pose`` and ``J_point`` chains over the
    projection Jacobian's rows. Another camera model keeps
    ``_eval_factors`` (not restated)."""
    if cam_model != cameras.PINHOLE:
        return _eval_factors(poses, points, prob, cam_model)
    kf = prob.kf_idx.long()
    Rk = poses.R[kf]
    pc = _chain(Rk, points[prob.mp_idx.long()][:, None, :]) + poses.t[kf]
    fx, fy, cx, cy = prob.cam_params[0], prob.cam_params[1], \
        prob.cam_params[2], prob.cam_params[3]
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    zi = 1.0 / cameras._safe_z(z)
    u = fma_f32(fx * x, zi, cx.expand_as(x))
    v = fma_f32(fy * y, zi, cy.expand_as(y))
    r = torch.stack([u - prob.uv[:, 0], v - prob.uv[:, 1]], dim=-1)
    zi2 = zi * zi
    zero = torch.zeros_like(x)
    row0 = torch.stack([fx * zi, zero, -fx * x * zi2], dim=-1)
    rows = [row0, torch.stack([zero, fy * zi, -fy * y * zi2], dim=-1)]
    if prob.stereo_mask is not None:
        zc = torch.clamp(z, min=1e-6)
        r = torch.cat([r, torch.where(prob.stereo_mask, u - prob.bf / zc
                                      - prob.u_right, zero)[:, None]], dim=-1)
        dur = row0 + torch.stack([zero, zero, prob.bf / (zc * zc)], dim=-1)
        rows.append(torch.where(prob.stereo_mask[:, None], dur,
                                torch.zeros_like(dur)))
    Jproj = torch.stack(rows, dim=-2)[:, :, None, :]           # (F,R,1,3)
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(
        pc.shape[:-1] + (3, 3))
    Jpc = torch.cat([eye, -lie.hat(pc)], dim=-1)               # (F,3,6)
    J_pose = _chain(Jproj, Jpc.transpose(-1, -2)[:, None])     # (F,R,6)
    J_point = _chain(Jproj, Rk.transpose(-1, -2)[:, None])     # (F,R,3)
    finite = ((z > 1e-4) & torch.isfinite(r).all(dim=-1)
              & torch.isfinite(J_pose).flatten(1).all(dim=-1)
              & torch.isfinite(J_point).flatten(1).all(dim=-1))
    z0 = torch.zeros((), dtype=r.dtype, device=r.device)
    return (torch.where(finite[..., None], r, z0),
            torch.where(finite[..., None, None], J_pose, z0),
            torch.where(finite[..., None, None], J_point, z0), finite)


def _pcg_weights(r: torch.Tensor, active: torch.Tensor, prob: BAProblem,
                 chi2_th: float, use_robust: bool) -> torch.Tensor:
    """Per-factor weight w: chi2 a chain of the squares from +0, the Huber
    weight min(delta rsqrt(chi2), 1) through XLA's ``rsqrt``, times the
    information; 0 where the factor is inactive."""
    zero = torch.zeros((), dtype=r.dtype, device=r.device)
    w = prob.inv_sigma2
    if use_robust:
        rr = torch.where(active[:, None], r, zero)
        chi2 = _chain(rr, rr) * prob.inv_sigma2
        th = _factor_chi2_th(prob, chi2_th)
        if not isinstance(th, torch.Tensor):
            th = torch.tensor(th, dtype=torch.float32, device=r.device)
        delta = torch.sqrt(th.double()).to(r.dtype)    # rounded once
        w_rob = torch.clamp(delta * rsqrt_f32(torch.clamp(chi2, min=1e-12)),
                            max=1.0)
        w = w_rob * prob.inv_sigma2
    return torch.where(active, w, zero)


def _pcg_landmark_system(r: torch.Tensor, Jl: torch.Tensor, w: torch.Tensor,
                         prob: BAProblem, lam: torch.Tensor):
    """(Hll, gl, Hll_inv) of the PCG step: the factors' blocks ``(Jl w)^T
    Jl`` (chains from +0) and ``w (Jl^T r)`` (a chain from its first
    product, the weight after it) summed over each landmark's slots, the
    damping ``Hll + (lam Hll) I + 1e-8 I``, the fixed points' rows, and the
    fused 3x3 inverse."""
    F = r.shape[0]
    dtype, dev = r.dtype, r.device
    fidx = torch.clamp(prob.lm_factor_idx.long(), 0, F - 1)
    vmf = prob.lm_factor_valid.to(dtype)
    JlT = Jl.transpose(-1, -2)
    gl_f = w[:, None] * _chain(JlT, r[:, None, :], plain_first=True)
    Hll_f = _chain((JlT * w[:, None, None])[:, :, None, :], JlT[:, None])
    # the 9-column gemv: columns 0-7 in its vector from +0, column 8 not
    cols = torch.arange(9, device=dev) < 8
    Hll = _slot_sum(Hll_f[fidx].flatten(2), vmf, cols).reshape(-1, 3, 3)
    gl = _slot_sum(gl_f[fidx], vmf, torch.zeros(3, dtype=torch.bool,
                                                device=dev))
    zero = torch.zeros((), dtype=dtype, device=dev)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    Hll_d = Hll + lam * Hll * eye3 + 1e-8 * eye3
    fixl = prob.fixed_point[:, None, None]
    Hll_d = torch.where(fixl, eye3, Hll_d)
    gl = torch.where(prob.fixed_point[:, None], zero, gl)
    return Hll, gl, torch.where(fixl, zero, _inv3x3_fused(Hll_d))


def _pcg_pose_system(r: torch.Tensor, Jp: torch.Tensor, Jl: torch.Tensor,
                     w: torch.Tensor, Hll_inv: torch.Tensor,
                     gl: torch.Tensor, prob: BAProblem, pose_stride: int):
    """(Hpp, g_r, Hpl_f) of the PCG step: ``Jp^T (w r)`` (from its first
    product), ``(Jp w)^T Jp`` and ``Jp^T (Jl w)`` (from +0), the pose
    segments summed as XLA's tree reduction, and the reduced gradient
    ``gp - sum_f Hpl_f (Hll_inv gl)`` (two chains from +0), zero on the
    fixed poses."""
    K = prob.fixed_pose.shape[0]
    mp = prob.mp_idx.long()
    JpT = Jp.transpose(-1, -2)

    def pose_sum(x):
        return window_sum_f32(x.reshape((K, pose_stride) + x.shape[1:]), 1)

    gp = pose_sum(_chain(JpT, (w[:, None] * r)[:, None, :],
                         plain_first=True))
    Hpp = pose_sum(_chain((JpT * w[:, None, None])[:, :, None, :],
                          JpT[:, None]))
    Hpl_f = _chain(JpT[:, :, None, :],
                   (Jl * w[:, None, None]).transpose(-1, -2)[:, None])
    y = _chain(Hll_inv[mp], gl[mp][:, None, :])               # (F,3)
    corr = _chain(Hpl_f, y[:, None, :])                        # (F,6)
    zero = torch.zeros((), dtype=r.dtype, device=r.device)
    g_r = torch.where(prob.fixed_pose[:, None], zero, gp - pose_sum(corr))
    return Hpp, g_r, Hpl_f


def _pcg_back_substitute(Hpl_f: torch.Tensor, dx_p: torch.Tensor,
                         Hll_inv: torch.Tensor, gl: torch.Tensor,
                         prob: BAProblem) -> torch.Tensor:
    """The landmark step ``Hll_inv (-gl - sum_slots Hpl_f^T dx_p)``: the
    factors' ``Hpl_f^T dx_p`` from their first product, the slots in
    order, the solve a chain from +0; zero on the fixed points."""
    F = Hpl_f.shape[0]
    fidx = torch.clamp(prob.lm_factor_idx.long(), 0, F - 1)
    vmf = prob.lm_factor_valid.to(gl.dtype)
    back_f = _chain(Hpl_f.transpose(-1, -2),
                    dx_p[prob.kf_idx.long()][:, None, :], plain_first=True)
    back = _slot_sum(back_f[fidx], vmf, torch.zeros(
        3, dtype=torch.bool, device=gl.device))
    dx_l = _chain(Hll_inv, (-gl - back)[:, None, :])
    return torch.where(prob.fixed_point[:, None],
                       torch.zeros((), dtype=gl.dtype, device=gl.device),
                       dx_l)


def _lm_step_cg(poses: lie.SE3, points: torch.Tensor, lam: torch.Tensor,
                inlier: torch.Tensor, prob: BAProblem, cam_model: str,
                chi2_th: float, use_robust: bool, pose_stride: int,
                cg_iters: int = 64):
    """One damped LM step solving the reduced camera system matrix-free:
    the Schur complement is applied as gathers and segment sums inside a
    block-Jacobi preconditioned conjugate-gradient solve of fixed length
    (updates frozen once the residual falls below 1e-7 of the start).
    Needs the window-contiguous layout kf_idx[f] == f // pose_stride. The
    linearization (factors, weights, landmark and pose systems, the
    back-substitution) rounds as the reference's compiled step; the
    preconditioner and the CG's own sums do not."""
    dtype, dev = points.dtype, points.device
    K = poses.t.shape[0]
    F = prob.kf_idx.shape[0]
    if pose_stride * K != F:
        raise ValueError(f"pose_stride {pose_stride} x K {K} != F {F}")

    r, Jp, Jl, depth_ok = _pcg_factors(poses, points, prob, cam_model)
    active = prob.valid & inlier & depth_ok
    w = _pcg_weights(r, active, prob, chi2_th, use_robust)
    _, gl, Hll_inv = _pcg_landmark_system(r, Jl, w, prob, lam)
    Hpp, g_r, Hpl_f = _pcg_pose_system(r, Jp, Jl, w, Hll_inv, gl, prob,
                                       pose_stride)

    def pose_sum(x):
        return x.reshape((K, pose_stride) + x.shape[1:]).sum(dim=1)

    zero = torch.zeros((), dtype=dtype, device=dev)
    fp = prob.fixed_pose
    kf = prob.kf_idx.long()
    mp = prob.mp_idx.long()
    fidx = torch.clamp(prob.lm_factor_idx.long(), 0, F - 1)
    vmf = prob.lm_factor_valid.to(dtype)
    Hinv_of_f = Hll_inv[mp]                                    # (F,3,3)

    # block-Jacobi preconditioner from the exact diagonal of S (each
    # landmark sees a pose through at most one factor in this layout),
    # formed and factored in float64: in float32 the cancellation in
    # Hpp - sum D_f can leave an ill-conditioned pose block indefinite,
    # and its NaN inverse stalls the whole CG (ROADMAP C9)
    f64 = torch.float64
    D_f = torch.einsum("fik,fkl,fjl->fij", Hpl_f.to(f64),
                       Hinv_of_f.to(f64), Hpl_f.to(f64))
    S_diag = Hpp.to(f64) - pose_sum(D_f)
    dvec = torch.diagonal(S_diag, dim1=-2, dim2=-1)
    eye6 = torch.eye(6, dtype=f64, device=dev)
    S_diag = S_diag + (lam.to(f64) * dvec + 1e-8)[:, :, None] * eye6
    S_diag = torch.where(fp[:, None, None], eye6, S_diag)
    Minv = solve_pos(S_diag, eye6.expand(S_diag.shape)).to(dtype)
    damp = (lam.to(f64) * dvec + 1e-8).to(dtype)

    def matvec(v):
        v = torch.where(fp[:, None], zero, v)
        t1 = torch.einsum("fki,fk->fi", Hpl_f, v[kf])          # (F,3)
        s_m = torch.einsum("mo,moi->mi", vmf, t1[fidx])        # (M,3)
        y = torch.einsum("mij,mj->mi", Hll_inv, s_m)
        z = torch.einsum("fik,fk->fi", Hpl_f, y[mp])           # (F,6)
        Sv = torch.einsum("kij,kj->ki", Hpp, v) - pose_sum(z) + damp * v
        return torch.where(fp[:, None], v, Sv)

    def precon(x):
        return torch.einsum("kij,kj->ki", Minv, x)

    b = -g_r
    x = torch.zeros_like(b)
    res = b
    p = precon(res)
    rz = torch.sum(res * p)
    tol = 1e-7 * torch.sqrt(torch.sum(b * b))
    for _ in range(cg_iters):
        Ap = matvec(p)
        denom = torch.sum(p * Ap)
        alpha = torch.where(torch.abs(denom) > 1e-20, rz / denom, zero)
        x2 = x + alpha * p
        r2 = res - alpha * Ap
        z2 = precon(r2)
        rz2 = torch.sum(r2 * z2)
        beta = torch.where(torch.abs(rz) > 1e-20, rz2 / rz, zero)
        p2 = z2 + beta * p
        live = torch.sqrt(torch.sum(r2 * r2)) > tol
        x = torch.where(live, x2, x)
        res = torch.where(live, r2, res)
        p = torch.where(live, p2, p)
        rz = torch.where(live, rz2, rz)
    dx_p = torch.where(fp[:, None], zero, x)
    dx_l = _pcg_back_substitute(Hpl_f, dx_p, Hll_inv, gl, prob)
    return lie.se3_boxplus(poses, dx_p), points + dx_l, active


def lm_cost(poses, points, inlier, prob: BAProblem, cam_model: str,
            chi2_th: float = CHI2_2D) -> torch.Tensor:
    """Masked robust cost at a state (the LM accept-test objective)."""
    r, fin = _eval_residuals(poses, points, prob, cam_model)
    return _robust_cost(r, prob.inv_sigma2, prob.valid & inlier & fin,
                        _factor_chi2_th(prob, chi2_th))[0]


def inlier_mask(poses, points, prob: BAProblem, cam_model: str,
                chi2_th: float = CHI2_2D) -> torch.Tensor:
    """chi2 inlier classification at a state."""
    r, fin = _eval_residuals(poses, points, prob, cam_model)
    chi2 = torch.sum(r * r, dim=-1) * prob.inv_sigma2
    return (chi2 <= _factor_chi2_th(prob, chi2_th)) & fin & prob.valid


def lm_chunk(poses, points, lam, cost0, inlier, prob: BAProblem,
             cam_model: str, iters: int, chi2_th: float, use_robust: bool,
             pose_stride: int = 0, window_layout: bool = False):
    """Resumable LM: ``iters`` iterations from an explicit (lam, cost)
    carry, accept decisions on the device. ``pose_stride > 0`` selects the
    matrix-free PCG step, else the dense Schur step (``window_layout``
    its reshape fast path). Returns the updated carry (poses, points,
    lam, cost) and the list of candidate costs."""
    costs: List[torch.Tensor] = []
    for _ in range(iters):
        if pose_stride > 0:
            cand_poses, cand_points, _ = _lm_step_cg(
                poses, points, lam, inlier, prob, cam_model, chi2_th,
                use_robust, pose_stride)
        else:
            cand_poses, cand_points, _ = _lm_step(
                poses, points, lam, inlier, prob, cam_model, chi2_th,
                use_robust, window_layout)
        cost1 = lm_cost(cand_poses, cand_points, inlier, prob, cam_model,
                        chi2_th)
        finite = (torch.isfinite(cand_poses.t).all()
                  & torch.isfinite(cand_poses.R).all()
                  & torch.isfinite(cand_points).all()
                  & torch.isfinite(cost1))
        accept = (cost1 < cost0) & finite
        poses = lie.SE3(torch.where(accept, cand_poses.R, poses.R),
                        torch.where(accept, cand_poses.t, poses.t))
        points = torch.where(accept, cand_points, points)
        lam = torch.where(accept, torch.clamp(lam * (1.0 / 3.0), min=1e-8),
                          torch.clamp(lam * 4.0, max=1e6))
        cost0 = torch.where(accept, cost1, cost0)
        costs.append(cost1)
    return poses, points, lam, cost0, costs


def _lm_run(poses, points, inlier, prob: BAProblem, cam_model: str,
            iters: int, chi2_th: float, use_robust: bool,
            window_layout: bool = False):
    cost0 = lm_cost(poses, points, inlier, prob, cam_model, chi2_th)
    lam = torch.full((), 1e-4, dtype=points.dtype, device=points.device)
    poses, points, _, _, costs = lm_chunk(
        poses, points, lam, cost0, inlier, prob, cam_model, iters, chi2_th,
        use_robust, window_layout=window_layout)
    return poses, points, costs


def bundle_adjustment(prob: BAProblem, cam_model: str = cameras.PINHOLE,
                      iters_first: int = 5, iters_second: int = 10,
                      chi2_th: float = CHI2_2D, window_layout: bool = False
                      ) -> Tuple[lie.SE3, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    """Two-phase robust BA: ``iters_first`` Huber-LM iterations, chi2
    re-mask, ``iters_second`` plain iterations. Returns (poses, points,
    inlier mask (F,), candidate costs (iters,))."""
    inlier = torch.ones_like(prob.valid)
    poses, points, costs1 = _lm_run(prob.poses, prob.points, inlier, prob,
                                    cam_model, iters_first, chi2_th, True,
                                    window_layout)
    inlier = inlier_mask(poses, points, prob, cam_model, chi2_th)
    poses, points, costs2 = _lm_run(poses, points, inlier, prob, cam_model,
                                    iters_second, chi2_th, False,
                                    window_layout)
    inlier = inlier_mask(poses, points, prob, cam_model, chi2_th)
    return poses, points, inlier, torch.stack(costs1 + costs2)


class ChunkedLM:
    """Host-side resumable two-phase robust LM over a BAProblem.

    The carry (poses, points, lam, cost, inlier) stays on the device;
    ``step()`` advances it by ``chunk`` iterations with no host sync, so
    the tracker can interleave frames between chunks. Phase 0 runs
    ``iters_first`` robust iterations, then the chi2 outlier re-mask and a
    trust-region restart, phase 1 ``iters_second`` plain ones. Dropping
    the object aborts the solve.
    """

    def __init__(self, prob: BAProblem, cam_model: str,
                 iters_first: int = 5, iters_second: int = 10,
                 chunk: int = 3, chi2_th: float = CHI2_2D,
                 pose_stride: int = 0, window_layout: bool = False):
        self.prob = prob
        # pose_stride > 0: the matrix-free PCG step (global BA over the
        # observation_triples layout at grown capacities)
        self.pose_stride = pose_stride
        self.window_layout = window_layout
        self.cam_model = cam_model
        self.chi2_th = chi2_th
        self.poses = prob.poses
        self.points = prob.points
        self.inlier = torch.ones_like(prob.valid)
        self.lam = self._lam0()
        self.cost = lm_cost(self.poses, self.points, self.inlier, prob,
                            cam_model, chi2_th)
        self.left = [iters_first, iters_second]
        self.phase = 0
        self.chunk = chunk

    def _lam0(self) -> torch.Tensor:
        return torch.full((), 1e-4, dtype=self.points.dtype,
                          device=self.points.device)

    @property
    def done(self) -> bool:
        return self.phase >= 2

    def step(self) -> bool:
        """Advance one chunk; True when finished."""
        if self.done:
            return True
        n = min(self.chunk, self.left[self.phase])
        self.poses, self.points, self.lam, self.cost, _ = lm_chunk(
            self.poses, self.points, self.lam, self.cost, self.inlier,
            self.prob, self.cam_model, n, self.chi2_th, self.phase == 0,
            self.pose_stride, self.window_layout)
        self.left[self.phase] -= n
        if self.left[self.phase] <= 0:
            self.phase += 1
            if self.phase == 1:
                # between-phase outlier re-mask + trust-region restart
                self.inlier = inlier_mask(self.poses, self.points,
                                          self.prob, self.cam_model,
                                          self.chi2_th)
                self.cost = lm_cost(self.poses, self.points, self.inlier,
                                    self.prob, self.cam_model, self.chi2_th)
                self.lam = self._lam0()
        return self.done
