"""Fused thin-level kernels: K3 (w-Gibbs) and K4/K5 (decision sweep).

``thin_gibbs_level`` and ``thin_decision_level`` are the wrappers of the
CUDA kernels in ``csrc/thin_level.cu``, which replace the Pallas TPU kernels
``spamtree_tpu/ops/pallas_level.py::thin_gibbs_level`` (K3) and
``thin_decision_level`` with both of its bodies (K4, and K5 =
``_thin_decision_kernel_vpu``; the split was a TPU layout artefact, one CUDA
kernel covers both).  ``thin_gibbs_level_plain`` and
``thin_decision_level_plain`` are the plain PyTorch versions of the same
functions: the wrappers use them for tensors on the CPU, and the tests and
``chip_smoke.py`` hold the kernels against them.  ``thin_decision_chains``
runs K4 for C batched chains as one launch over their folded C*B blocks.

Both kernels are opt-in on the model's paths, gated like the JAX package's
by ``SPAMTREE_LEVEL_KERNELS`` (default off), read at call time.
"""

from __future__ import annotations

import ctypes
import os

import torch

from spamtree_tpu_torch.ops import kernel_counts
from spamtree_tpu_torch.utils.cost import counted

# the JAX package's static gate (pallas_level.py:39-40)
MAX_P = 1024
MAX_S = 512

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_bound: dict = {}


def use_level_kernels() -> bool:
    """Opt-in gate (``SPAMTREE_LEVEL_KERNELS=1``); default off, as in the
    JAX package."""
    return os.environ.get("SPAMTREE_LEVEL_KERNELS", "0") not in (
        "0", "false", "")


def _kernel(name: str, dtype):
    """The ctypes entry point ``st_<name>_<dtype>``; builds the library at
    first use."""
    key = (name, dtype)
    if key not in _bound:
        from spamtree_tpu_torch.ops import _build

        fn = getattr(_build.load("thin_level"), f"st_{name}_{_SUFFIX[dtype]}")
        n_ptr = {"thin_gibbs": 9, "thin_decision": 10}[name]
        fn.argtypes = ([ctypes.c_void_p] * n_ptr
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _bound[key] = fn
    return _bound[key]


def thin_gibbs_variant(S: int, P: int, dtype=torch.float32) -> str:
    """The K3 variant the launcher takes at (S, P), as it reports it:
    ``flat`` (one warp per tree block, the slab in shared memory),
    ``rows<WARPS>x<RPW>x<CPL>`` (one thread block per tree block, RPW x CPL
    slab values in each thread's registers) or ``tiled``.  Builds the
    library at first use."""
    from spamtree_tpu_torch.ops import _build

    fn = getattr(_build.load("thin_level"),
                 f"st_thin_gibbs_variant_{_SUFFIX[dtype]}")
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    code = fn(S, P)
    if code < 2:
        return ("tiled", "flat")[code]
    return f"rows{code // 10000}x{code // 100 % 100}x{code % 100}"


def _check(fname: str, shapes: dict, dtype, device):
    """Device, dtype, shape and contiguity checks shared by the wrappers;
    ``shapes`` maps an argument name to (tensor, expected shape)."""
    if dtype not in _SUFFIX:
        raise TypeError(f"{fname}: dtype {dtype} not in (float32, float64)")
    if device.type != "cuda":
        raise ValueError(f"{fname}: unsupported device {device}")
    for nm, (a, shape) in shapes.items():
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"{fname}: {nm} has shape {tuple(a.shape)}, "
                             f"expected {tuple(shape)}")
        if a.device != device:
            raise ValueError(f"{fname}: {nm} is on {a.device}, not {device}")
        if not a.is_contiguous():
            raise ValueError(f"{fname}: {nm} must be contiguous")


def thin_gibbs_cost(B: int, S: int, P: int, dtype) -> tuple:
    """(flops, bytes) of one K3 call: H (B,S,P), wpar (B,P) and five (B,S)
    vectors read once, wu (B,S) and msg (B,P) written once; 4 B S P
    operations (H wpar and H' prec (wu - hw))."""
    return 4 * B * S * P, dtype.itemsize * (B * S * P + 6 * B * S + 2 * B * P)


def thin_decision_cost(B: int, S: int, P: int, dtype, slabs=None,
                       aligned: bool = True) -> tuple:
    """(flops, bytes) of one K4 call over B blocks: Kxc (B,P,S) and prevH
    (B,S,P), ``slabs`` parent slabs (P,P) (default B; a wrapper reading
    shapes alone cannot know how many distinct parents lp_pos names), wpar
    (B,P), four (B,S) vectors and, unless aligned, lp_pos (int64) read
    once, the (B,4) partials written once; 2 P^2 (S + 1) B + 6 P S B
    operations (M = LAi Kxc, u = LAi wpar, then hk, hw and the sums)."""
    slabs = B if slabs is None else slabs
    return (2 * P * P * (S + 1) * B + 6 * P * S * B,
            dtype.itemsize * (2 * B * P * S + slabs * P * P + B * P
                              + 4 * B * S + 4 * B)
            + (0 if aligned else 8 * B))


def _k4_work(Kxc, joint, aligned, **_):
    """K4's work from its wrappers' arguments: (B, P, S) blocks on (Bp, P,
    P) parents, or (C, B, P, S) on (C, Bp, P, P) folded over chains."""
    *lead, P, S = Kxc.shape
    B, Bp = lead[-1], joint.shape[-3]
    C = lead[0] if len(lead) == 2 else 1
    return thin_decision_cost(C * B, S, P, Kxc.dtype,
                              slabs=C * (B if aligned else min(B, Bp)),
                              aligned=aligned)


def thin_gibbs_level_plain(H, prec, wpar, z, ti, resid, rmask_f):
    """(wu, msg) of one thin level's w-Gibbs update (``thin_gibbs_level``)."""
    hw = torch.einsum("bsp,bp->bs", H, wpar)
    sig = prec + ti
    wu = (prec * hw + resid) / sig + z / torch.sqrt(sig)
    wu = torch.where(rmask_f > 0.5, wu, 0.0)
    msg = torch.einsum("bsp,bs->bp", H, prec * (wu - hw))
    return wu, msg


@counted(lambda H, **_: thin_gibbs_cost(*H.shape, H.dtype))
def thin_gibbs_level(H, prec, wpar, z, ti, resid, rmask_f):
    """Fused w-Gibbs body of one thin level: (wu, msg).

    H (B,S,P) stored conditional-mean operators; prec (B,S) stored
    precisions; wpar (B,P); z (B,S) standard normals; ti (B,S) per-row noise
    precision; resid (B,S) = ti*(y - XB); rmask_f (B,S) 0/1.  Returns wu
    (B,S) = (prec*hw + resid)/sig + z/sqrt(sig) masked to 0, with hw = H wpar
    and sig = prec + ti, and msg (B,P) = H' prec (wu - hw).  CUDA tensors
    launch kernel K3; CPU tensors take ``thin_gibbs_level_plain``.

    The launcher picks K3's variant from (S, P, dtype) alone
    (``thin_gibbs_variant``): slabs with P <= 32, S <= 128 and S*P <= 1536
    sit in one warp's shared memory, eight tree blocks to a thread block
    (the limited tree's thin levels); slabs up to (72, 320) in float32 or
    (80, 320) in float64 sit in one thread block's registers (the full
    tree's thin level); both read H once.  Anything larger, up to the gate,
    takes the tiled variant, which reads H twice.  Each launch counts as
    ``k3_launches`` (``ops.kernel_counts``)."""
    if H.device.type == "cpu":
        return thin_gibbs_level_plain(H, prec, wpar, z, ti, resid, rmask_f)
    if H.dim() != 3:
        raise ValueError(f"thin_gibbs_level: H must be (B, S, P), got "
                         f"{tuple(H.shape)}")
    B, S, P = H.shape
    if B < 1 or not 1 <= S <= MAX_S or not 1 <= P <= MAX_P:
        raise ValueError(f"thin_gibbs_level: need B >= 1, 1 <= S <= {MAX_S}, "
                         f"1 <= P <= {MAX_P}, got B={B}, S={S}, P={P}")
    vecs = dict(prec=prec, z=z, ti=ti, resid=resid, rmask_f=rmask_f)
    if any(a.dtype != H.dtype for a in (wpar, *vecs.values())):
        raise TypeError("thin_gibbs_level: all inputs must share H's dtype")
    _check("thin_gibbs_level",
           dict(H=(H, (B, S, P)), wpar=(wpar, (B, P)),
                **{k: (a, (B, S)) for k, a in vecs.items()}),
           H.dtype, H.device)
    fn = _kernel("thin_gibbs", H.dtype)
    wu = torch.empty((B, S), dtype=H.dtype, device=H.device)
    msg = torch.empty((B, P), dtype=H.dtype, device=H.device)
    with torch.cuda.device(H.device):
        stream = torch.cuda.current_stream(H.device).cuda_stream
        err = fn(H.data_ptr(), prec.data_ptr(), wpar.data_ptr(), z.data_ptr(),
                 ti.data_ptr(), resid.data_ptr(), rmask_f.data_ptr(),
                 wu.data_ptr(), msg.data_ptr(), B, S, P, stream)
    if err != 0:
        raise RuntimeError(f"thin_gibbs kernel launch failed: CUDA error {err}")
    kernel_counts.add("k3_launches")
    return wu, msg


def _decision_reduce(part):
    """(..., B, 4) per-block partials (logdet, qn, qc, ok) -> the level's
    (logdet, ok, qn, qc), as the JAX wrapper reduces its kernel's rows; one
    of each per chain for (C, B, 4)."""
    return (part[..., 0].sum(-1), part[..., 3].amin(-1) > 0.5,
            part[..., 1].sum(-1), part[..., 2].sum(-1))


def thin_decision_partials_plain(Kxc, joint, lp_pos, wpar, w_r, prevH,
                                 prevprec, kdiag, rmask_f, aligned=False):
    """Per-block (B, 4) partials (logdet, qn, qc, ok) of
    ``thin_decision_level``, the plain PyTorch version."""
    LAi = (joint if aligned else joint[lp_pos]).to(Kxc.dtype)
    M = LAi @ Kxc
    hk = torch.sum(M * M, dim=1)
    hw = torch.einsum("bps,bp->bs", M, torch.einsum("bpq,bq->bp", LAi, wpar))
    rmask = rmask_f > 0.5
    r = torch.where(rmask, kdiag - hk, 1.0)
    okl = torch.isfinite(r) & (r > 0)
    r = torch.where(okl, r, 1.0)
    logdet = -0.5 * torch.sum(torch.where(rmask, torch.log(r), 0.0), dim=1)
    wx = w_r - hw
    qn = -0.5 * torch.sum(wx * wx / r, dim=1)
    wxc = w_r - torch.einsum("bsp,bp->bs", prevH, wpar)
    qc = -0.5 * torch.sum(prevprec * wxc * wxc, dim=1)
    ok = torch.all(okl, dim=1).to(Kxc.dtype)
    return torch.stack([logdet, qn, qc, ok], dim=1)


def thin_decision_level_plain(Kxc, joint, lp_pos, wpar, w_r, prevH, prevprec,
                              kdiag, rmask_f, aligned=False):
    """(logdet, ok, qn, qc) of ``thin_decision_level``, plain PyTorch."""
    return _decision_reduce(thin_decision_partials_plain(
        Kxc, joint, lp_pos, wpar, w_r, prevH, prevprec, kdiag, rmask_f,
        aligned))


@counted(_k4_work)
def thin_decision_partials(Kxc, joint, lp_pos, wpar, w_r, prevH, prevprec,
                           kdiag, rmask_f, aligned=False):
    """Per-block (B, 4) partials (logdet, qn, qc, ok) from kernel K4 (CUDA
    tensors) or from ``thin_decision_partials_plain`` (CPU tensors); each
    launch counts as ``k4_launches`` (``ops.kernel_counts``)."""
    if Kxc.device.type == "cpu":
        return thin_decision_partials_plain(Kxc, joint, lp_pos, wpar, w_r,
                                            prevH, prevprec, kdiag, rmask_f,
                                            aligned)
    if Kxc.dim() != 3 or joint.dim() != 3:
        raise ValueError("thin_decision_level: Kxc must be (B, P, S) and "
                         "joint (Bp, P, P)")
    B, P, S = Kxc.shape
    Bp = joint.shape[0]
    if B < 1 or not 1 <= S <= MAX_S or not 1 <= P <= MAX_P:
        raise ValueError(f"thin_decision_level: need B >= 1, 1 <= S <= "
                         f"{MAX_S}, 1 <= P <= {MAX_P}, got B={B}, S={S}, P={P}")
    if aligned and Bp != B:
        raise ValueError(f"thin_decision_level: aligned needs the joint batch "
                         f"to match B={B}, got {Bp}")
    vecs = dict(w_r=w_r, prevprec=prevprec, kdiag=kdiag, rmask_f=rmask_f)
    if any(a.dtype != Kxc.dtype for a in (joint, wpar, prevH, *vecs.values())):
        raise TypeError("thin_decision_level: all float inputs must share "
                        "Kxc's dtype")
    if lp_pos.dtype != torch.int64:
        raise TypeError(f"thin_decision_level: lp_pos must be int64, got "
                        f"{lp_pos.dtype}")
    _check("thin_decision_level",
           dict(Kxc=(Kxc, (B, P, S)), joint=(joint, (Bp, P, P)),
                lp_pos=(lp_pos, (B,)), wpar=(wpar, (B, P)),
                prevH=(prevH, (B, S, P)),
                **{k: (a, (B, S)) for k, a in vecs.items()}),
           Kxc.dtype, Kxc.device)
    fn = _kernel("thin_decision", Kxc.dtype)
    part = torch.empty((B, 4), dtype=Kxc.dtype, device=Kxc.device)
    with torch.cuda.device(Kxc.device):
        stream = torch.cuda.current_stream(Kxc.device).cuda_stream
        # aligned: the kernel reads parent slab b for block b (lp_pos unread)
        err = fn(Kxc.data_ptr(), joint.data_ptr(),
                 None if aligned else lp_pos.data_ptr(), wpar.data_ptr(),
                 w_r.data_ptr(), prevH.data_ptr(), prevprec.data_ptr(),
                 kdiag.data_ptr(), rmask_f.data_ptr(), part.data_ptr(),
                 B, S, P, stream)
    if err != 0:
        raise RuntimeError(
            f"thin_decision kernel launch failed: CUDA error {err}")
    kernel_counts.add("k4_launches")
    return part


@counted(_k4_work)
def thin_decision_level(Kxc, joint, lp_pos, wpar, w_r, prevH, prevprec,
                        kdiag, rmask_f, aligned=False):
    """Fused decision-sweep body of one thin level: (logdet, ok, qn, qc).

    Kxc (B,P,S) masked cross-covariance; joint (Bp,P,P) parent joint-factor
    batch; lp_pos (B,) int64 parent position of each block (unread when
    ``aligned``, where Bp == B and block b takes slab b); wpar (B,P); w_r,
    prevprec, kdiag, rmask_f (B,S); prevH (B,S,P).  Per block, with
    LAi = joint[lp_pos[b]] and M = LAi Kxc: hk = sum_p M^2, hw = M'(LAi
    wpar), r = kdiag - hk on masked-in rows (1 elsewhere), ok = all r finite
    and > 0, logdet = -1/2 sum log r, qn = -1/2 sum (w_r - hw)^2 / r and
    qc = -1/2 sum prevprec (w_r - prevH wpar)^2; the per-block values are
    summed (ok: all) over B outside the kernel."""
    return _decision_reduce(thin_decision_partials(
        Kxc, joint, lp_pos, wpar, w_r, prevH, prevprec, kdiag, rmask_f,
        aligned))


def _fold_chains(Kxc, joint, lp_pos, wpar, w_r, prevH, prevprec, kdiag,
                 rmask_f):
    """The chains' level inputs as one batch of C*B blocks: block b of chain
    c reads parent slab c*Bp + lp_pos[b]; lp_pos and rmask_f are repeated
    per chain."""
    if Kxc.dim() != 4 or joint.dim() != 4:
        raise ValueError("thin_decision_chains: Kxc must be (C, B, P, S) and "
                         "joint (C, Bp, P, P)")
    C, Bp = joint.shape[:2]
    fold = lambda a: a.reshape((-1,) + tuple(a.shape[2:]))
    lp = lp_pos + Bp * torch.arange(C, device=lp_pos.device)[:, None]
    return (fold(Kxc), fold(joint), lp.reshape(-1), fold(wpar), fold(w_r),
            fold(prevH), fold(prevprec), fold(kdiag), rmask_f.repeat(C, 1))


def thin_decision_chains_plain(Kxc, joint, lp_pos, wpar, w_r, prevH, prevprec,
                               kdiag, rmask_f, aligned=False):
    """(logdet, ok, qn, qc) of ``thin_decision_chains``, plain PyTorch on
    the same fold."""
    return _decision_reduce(thin_decision_partials_plain(
        *_fold_chains(Kxc, joint, lp_pos, wpar, w_r, prevH, prevprec, kdiag,
                      rmask_f), aligned).reshape(Kxc.shape[0], -1, 4))


@counted(_k4_work)
def thin_decision_chains(Kxc, joint, lp_pos, wpar, w_r, prevH, prevprec,
                         kdiag, rmask_f, aligned=False):
    """``thin_decision_level`` for C chains in one K4 launch: (logdet, ok,
    qn, qc), each (C,) over its own chain's blocks.

    Kxc (C,B,P,S); joint (C,Bp,P,P); wpar (C,B,P); w_r, prevprec, kdiag
    (C,B,S); prevH (C,B,S,P); lp_pos (B,) and rmask_f (B,S) are the
    level's, shared by the chains.  The chains fold into one batch of C*B
    blocks: block b of chain c reads parent slab c*Bp + lp_pos[b] (aligned:
    slab c*B + b, as Bp == B), and the (C*B, 4) partials are reduced per
    chain.  CUDA tensors launch kernel K4 once; CPU tensors take
    ``thin_decision_chains_plain``."""
    return _decision_reduce(thin_decision_partials(
        *_fold_chains(Kxc, joint, lp_pos, wpar, w_r, prevH, prevprec, kdiag,
                      rmask_f), aligned).reshape(Kxc.shape[0], -1, 4))
