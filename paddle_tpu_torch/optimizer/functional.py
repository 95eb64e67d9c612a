"""Functional optimizer steps for the training path — the port of
paddle_tpu/optimizer/functional.

Pure functions over parameter trees (nested dicts of tensors); the
optimizer "memory modes" are the dtypes and shapes of the moment trees:

  * ``adamw`` + f32 moments: 8 bytes/param of optimizer state.
  * ``adamw`` + bf16 moments: 4 bytes/param.
  * ``adafactor``: O(rows+cols) second moment, no first moment.

All math runs in f32 whatever the storage dtype; params may themselves be
stored bf16 — updates are computed in f32 and cast back. The step count is
a 0-d device tensor and every bias correction is computed from it on the
device, so an update never waits on the host. Each function returns new
tensors and leaves its inputs as they were.

Sharded state (one process a device, each holding its slices):
:func:`moment_shardings` gives the moments' spec trees from the params'
(``distributed.mesh.PartitionSpec``); ``optimizer_update(mesh=, specs=)``
runs on the calling rank's slices. adamw is elementwise; adafactor's
whole-leaf reductions (the row and column means of g², the mean of vr,
the update's RMS) sum their slices over the mesh dims that split the
reduced dims and divide by the whole dims, so each rank's slices equal
the unsharded update's.
"""
from __future__ import annotations

import math

import torch

__all__ = ["tree_map", "tree_leaves", "init_moments", "moment_shardings",
           "optimizer_update", "adamw_update", "adafactor_update"]

_f32 = torch.float32


def tree_map(f, tree, *rest):
    """``f`` over the leaves of ``tree``, a nested dict (anything else is a
    leaf), with the matching entries of the trees in ``rest``, which follow
    ``tree``'s structure and may hold anything (a dict too) where ``tree``
    holds a leaf — ``jax.tree_util.tree_map`` with ``flatten_up_to``."""
    if isinstance(tree, dict):
        return {k: tree_map(f, tree[k], *(r[k] for r in rest)) for k in tree}
    return f(tree, *rest)


def tree_leaves(tree):
    """The leaves of a nested dict, in the order :func:`tree_map` visits
    them."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def init_moments(params, optimizer: str = "adamw", moment_dtype=_f32):
    """Return (mu, nu) moment trees for ``optimizer``.

    adamw: mu/nu shaped like params in ``moment_dtype``.
    adafactor: mu is per-leaf f32 zeros[()] placeholders (no first moment);
    nu leaves are dicts {"vr": [..., rows], "vc": [..., cols]} for ndim>=2
    (factored over the trailing two dims, leading stack dims kept) or
    {"v": full} for vectors and scalars.
    """
    if optimizer == "adamw":
        def zeros(p):
            return torch.zeros(p.shape, dtype=moment_dtype, device=p.device)
        return tree_map(zeros, params), tree_map(zeros, params)
    if optimizer == "adafactor":
        def nu_like(p):
            if p.dim() >= 2:
                return {"vr": torch.zeros(p.shape[:-1], dtype=_f32,
                                          device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=_f32, device=p.device)}
            return {"v": torch.zeros(p.shape, dtype=_f32, device=p.device)}

        mu = tree_map(lambda p: torch.zeros((), dtype=_f32,
                                            device=p.device), params)
        return mu, tree_map(nu_like, params)
    raise ValueError(f"unknown optimizer {optimizer!r}")


def _ndim(p) -> int:
    if hasattr(p, "dim") and callable(p.dim):
        return p.dim()
    return p.ndim if hasattr(p, "ndim") else len(p)


def moment_shardings(param_shardings, params, optimizer: str = "adamw"):
    """Spec trees for the (mu, nu) trees of ``init_moments``.

    adamw moments are param-shaped, so they reuse the param specs.
    adafactor's mu is scalar placeholders (``P()``) and nu is factored
    {"vr","vc"}/{"v"} dicts whose specs are the param spec with the
    reduced dim dropped. ``params`` may be tensors, shapes or anything
    with ``ndim`` (only the rank is read)."""
    from ..distributed.mesh import P

    if optimizer == "adamw":
        return param_shardings, param_shardings
    if optimizer == "adafactor":
        def nu_sh(s, p):
            nd = _ndim(p)
            spec = tuple(s) + (None,) * (nd - len(s))
            if nd >= 2:
                return {"vr": P(*spec[:-1]), "vc": P(*(spec[:-2] + spec[-1:]))}
            return {"v": P(*spec)}

        return (tree_map(lambda s, p: P(), param_shardings, params),
                tree_map(nu_sh, param_shardings, params))
    raise ValueError(f"unknown optimizer {optimizer!r}")


class _Split:
    """How one leaf's slice lies in the whole leaf: for each dim, the
    mesh dims of ``mesh`` that split it (from its spec). ``sum`` adds a
    reduction's partial sums over the ranks that hold the other parts of
    the reduced dims; ``whole`` is a dim's unsharded size."""

    def __init__(self, spec, shape, mesh):
        from ..distributed.mesh import axis_size, spec_axes

        spec = tuple(spec) + (None,) * (len(shape) - len(spec))
        self.mesh = mesh
        self.axes = [tuple(a for a in spec_axes(e) if axis_size(mesh, a) > 1)
                     for e in spec]
        self.shape = [n * math.prod(axis_size(mesh, a) for a in ax)
                      for n, ax in zip(shape, self.axes)]

    def whole(self, d: int) -> int:
        return self.shape[d]

    def sum(self, t, dims):
        """``t`` summed over the mesh dims that split param ``dims``."""
        from ..distributed.collective import all_reduce
        from ..distributed.mesh import axis_group

        names = sorted({a for d in dims for a in self.axes[d]})
        for a in names:
            t = all_reduce(t.contiguous(), group=axis_group(self.mesh, a))
        return t

    def mean(self, t, d: int, keepdim: bool = False):
        """The mean of a param-shaped slice along param dim ``d``."""
        return self.sum(t.sum(dim=d, keepdim=keepdim), [d]) / self.whole(d)


def adamw_update(p, g, m, n, *, lr, beta1, beta2, eps, wd, scale, bc1, bc2):
    """One AdamW leaf update; moments stored in their own dtype, math f32.
    Returns (new_p, new_m, new_n)."""
    g = g.to(_f32) * scale
    mf = beta1 * m.to(_f32) + (1 - beta1) * g
    nf = beta2 * n.to(_f32) + (1 - beta2) * g * g
    u = (mf / bc1) / (torch.sqrt(nf / bc2) + eps)
    pf = p.to(_f32)
    new_p = pf - lr * (u + wd * pf)
    return new_p.to(p.dtype), mf.to(m.dtype), nf.to(n.dtype)


# adafactor_update updates a stacked leaf ([L, ...]) of more than
# _ADAFACTOR_WHOLE elements in slices of its leading axis of at most
# _ADAFACTOR_CHUNK elements (one slice where a slice is larger)
_ADAFACTOR_WHOLE = 1 << 30
_ADAFACTOR_CHUNK = 1 << 27


def _adafactor_moments(g, nu, beta2t, eps1, split=None):
    """(v, new_nu) of one leaf or stacked slice: the decayed factored (or
    full) second moment and its rank-1 reconstruction v. ``split`` (a
    ``_Split``) makes the means span the whole leaf's dims."""
    g2 = g * g + eps1
    if "vr" in nu:
        if split is None:
            r, c = g2.mean(dim=-1), g2.mean(dim=-2)
        else:
            nd = g2.dim()
            r, c = split.mean(g2, nd - 1), split.mean(g2, nd - 2)
        vr = beta2t * nu["vr"] + (1 - beta2t) * r
        vc = beta2t * nu["vc"] + (1 - beta2t) * c
        return _factored_v(vr, vc, split), {"vr": vr, "vc": vc}
    v = beta2t * nu["v"] + (1 - beta2t) * g2
    return v, {"v": v}


def _factored_v(vr, vc, split=None):
    # v̂ = vr ⊗ vc / row-mean(vr)  (rank-1 reconstruction); vr's last dim
    # is the param's second-to-last
    if split is None:
        denom = vr.mean(dim=-1, keepdim=True)
    else:
        d = len(split.shape) - 2
        denom = split.sum(vr.sum(dim=-1, keepdim=True), [d]) / split.whole(d)
    return (vr / denom)[..., :, None] * vc[..., None, :]


def adafactor_update(p, g, nu, *, lr, beta2t, eps1, eps2, clip, wd, scale,
                     split=None):
    """One Adafactor leaf update (Shazeer & Stern 2018): factored second
    moment over the trailing two dims, RMS-clipped update, no first moment.
    ``lr`` is a float. ``split`` (a ``_Split``) marks ``p`` as a rank's
    slice of a sharded leaf. Returns (new_p, new_nu).

    A stacked leaf larger than ``_ADAFACTOR_WHOLE`` elements (the MoE
    experts, [L, E, h, f]: 2.2 G elements and 8.9 GB an f32 temporary at
    DeepSeekMoE's widths) is updated in slices of its leading axis, so
    the f32 temporaries stay the size of a slice: one pass computes the
    moments and the sum of u², the RMS over the whole leaf clips, and a
    second pass recomputes u and applies the update. The math is the
    whole-leaf update's; only the order of the f32 sum of u² differs."""
    step_size = max(eps2, lr)
    numel = p.numel() if split is None else math.prod(split.shape)
    all_dims = range(p.dim())

    def sum_all(t):
        return t if split is None else split.sum(t, all_dims)

    # leading-axis slices a pass (None: the whole leaf at once)
    n = max(1, _ADAFACTOR_CHUNK // p[0].numel()) \
        if p.dim() >= 3 and p.numel() > _ADAFACTOR_WHOLE else None
    if n is None or n >= p.shape[0]:
        gf = g.to(_f32) * scale
        v, new_nu = _adafactor_moments(gf, nu, beta2t, eps1, split)
        u = gf * torch.rsqrt(v + eps1)
        # clip the update's RMS to `clip` (d=1.0 in the paper)
        rms = torch.sqrt(sum_all((u * u).sum()) / numel + 1e-30)
        u = u / torch.clamp(rms / clip, min=1.0)
        pf = p.to(_f32)
        new_p = pf - step_size * (u + wd * pf)
        return new_p.to(p.dtype), new_nu
    parts, ss = [], torch.zeros((), dtype=_f32, device=p.device)
    for i in range(0, p.shape[0], n):
        gf = g[i:i + n].to(_f32) * scale
        v, part = _adafactor_moments(gf, tree_map(lambda t: t[i:i + n], nu),
                                     beta2t, eps1, split)
        u = gf * torch.rsqrt(v + eps1)
        ss = ss + (u * u).sum()
        parts.append(part)
    new_nu = {k: torch.cat([part[k] for part in parts]) for k in parts[0]}
    rms = torch.sqrt(sum_all(ss) / numel + 1e-30)
    div = torch.clamp(rms / clip, min=1.0)
    new_p = torch.empty_like(p)
    for i, part in zip(range(0, p.shape[0], n), parts):
        gf = g[i:i + n].to(_f32) * scale
        u = gf * torch.rsqrt(_factored_v(part["vr"], part["vc"], split)
                             + eps1) / div
        pf = p[i:i + n].to(_f32)
        new_p[i:i + n] = pf - step_size * (u + wd * pf)
    return new_p, new_nu


def optimizer_update(params, grads, mu, nu, step, *, optimizer="adamw",
                     lr=3e-4, beta1=0.9, beta2=0.95, eps=1e-8, wd=0.1,
                     scale=1.0, adafactor_clip=1.0, adafactor_eps2=1e-3,
                     mesh=None, specs=None):
    """Apply one optimizer step over whole trees. ``step`` is the 0-d int
    step count before this update; ``scale`` (a float or a 0-d tensor)
    folds in grad clipping. ``adafactor_eps2`` floors adafactor's step
    size, ``max(eps2, lr)``: 1e-3 as the JAX package hard-codes it (a
    random-init llama-2.6b's loss oscillates at that step; PERF.md).
    With ``mesh`` (a ``DeviceMesh``) and ``specs`` (the params' spec
    tree), the trees are the calling rank's slices and adafactor's
    reductions span the whole leaves (module docstring); every rank of
    the mesh must call it. Returns (params, mu, nu)."""
    if (mesh is None) != (specs is None):
        raise ValueError("optimizer_update: give both mesh= and specs=, "
                         "or neither")
    t = (step + 1).to(_f32)
    if optimizer == "adamw":
        bc1 = 1.0 - beta1 ** t
        bc2 = 1.0 - beta2 ** t
        outs = tree_map(
            lambda p, g, m, n: adamw_update(
                p, g, m, n, lr=lr, beta1=beta1, beta2=beta2, eps=eps, wd=wd,
                scale=scale, bc1=bc1, bc2=bc2),
            params, grads, mu, nu)
        return tuple(tree_map(lambda _, o, i=i: o[i], params, outs)
                     for i in range(3))
    if optimizer == "adafactor":
        # decaying beta2̂_t = 1 - t^-0.8 (paper §7), lr as relative step
        beta2t = 1.0 - t ** -0.8
        def split(p, s):
            return None if mesh is None else _Split(s, p.shape, mesh)

        outs = tree_map(
            lambda p, g, n, s: adafactor_update(
                p, g, n, lr=lr, beta2t=beta2t, eps1=1e-30,
                eps2=adafactor_eps2, clip=adafactor_clip, wd=wd,
                scale=scale, split=split(p, s)),
            params, grads, nu, specs if specs is not None
            else tree_map(lambda _: None, params))
        return (tree_map(lambda _, o: o[0], params, outs), mu,
                tree_map(lambda _, o: o[1], params, outs))
    raise ValueError(f"unknown optimizer {optimizer!r}")
