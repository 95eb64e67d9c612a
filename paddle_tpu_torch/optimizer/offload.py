"""Host-offloaded training memory modes — the port of
paddle_tpu/optimizer/offload (fit a bigger model on one card).

On a CUDA device "host memory" is page-locked (pinned) CPU memory, which
the card reads and writes by DMA while it computes. On a caller-chosen
CPU device there is no second memory: every step keeps its tensors where
they are, with the same structure and the same math, as the JAX package
does on its CPU backend. No step ever keeps its layers on the card in
place of the host when the card is asked for; a failed pin raises.

* **Gradient offload** (``make_offload_train_step(offload_grads=True)``):
  after the backward pass the gradients are copied to pinned host memory
  and the update walks the parameter tree leaf by leaf, fetching each
  leaf's gradient back. As in the JAX package this lowers what the
  gradients occupy between the phases, not the backward pass's peak
  (the whole gradient tree exists on the card before the copy).
* **Moment offload** (``offload_moments=True``): the optimizer moments
  live in pinned host memory between steps and stream through the card
  leaf by leaf inside the update; each leaf's moments are written back
  into their own pinned buffers (the port's form of buffer donation).
* **Layer-wise optimizer-in-backward** (``init_layerwise_train_state``,
  ``make_layerwise_train_step``): no gradient tree is ever formed; each
  layer's backward and adafactor update run together and the result is
  written into the stacked parameters in place.
* **Host-streamed layer-wise step** (``init_streaming_train_state``,
  ``make_streaming_train_step``; MoE: ``init_streaming_moe_train_state``,
  ``make_streaming_moe_train_step``): each layer's parameters and second
  moments live in their own exact-size pinned block; a copy stream
  fetches layer l+1 while layer l computes and a second one parks each
  updated layer back into its block while the next computes.

All modes use the updates of ``optimizer/functional.py``; the math is the
fused step's, layer by layer (no global-norm clip in the layer-wise and
streaming steps: no gradient tree exists to take it over).
"""
from __future__ import annotations

import math
import weakref
from typing import Optional

import torch

from ..device import resolve_device
from .functional import adafactor_update, adamw_update, tree_leaves, tree_map

__all__ = ["host_put", "device_put_leaf", "make_offload_train_step",
           "make_layerwise_train_step", "init_layerwise_train_state",
           "init_offload_train_state",
           "StreamTrainState", "init_streaming_train_state",
           "make_streaming_train_step", "streaming_state_from_layerwise",
           "layerwise_state_from_streaming",
           "init_streaming_moe_train_state", "make_streaming_moe_train_step",
           "supports_host_memory", "supports_compiled_host_memory",
           "layerwise_state_from_numpy", "streaming_state_from_numpy",
           "pinned_bytes"]

_f32 = torch.float32
# byte alignment of each leaf inside a pinned block
_ALIGN = 256


def supports_host_memory(device="cuda") -> bool:
    """True where the steps park tensors in host memory: a CUDA device
    (pinned CPU memory). False on the CPU, where they keep everything in
    place. Asking about ``cuda`` without a card raises."""
    return resolve_device(device).type == "cuda"


def supports_compiled_host_memory(device="cuda") -> bool:
    """As :func:`supports_host_memory`: the port's steps read pinned
    memory through their own copies, so the JAX package's second question
    (can a compiled program address the host memory space) has the same
    answer."""
    return supports_host_memory(device)


# ---------------------------------------------------------------------------
# pinned host blocks
# ---------------------------------------------------------------------------
class _PinnedBlock:
    """One exact-size page-locked host buffer: a plain CPU tensor
    registered with ``cudaHostRegister``. ``pin_memory=True`` goes through
    torch's caching host allocator, which rounds a block up to a power of
    two (a 1.18 GB MoE layer would pin 2 GB); a registered buffer pins
    what it holds. The block is unregistered when the last leaf view that
    carries it is gone (after the card's pending work, which may still be
    copying into it)."""

    def __init__(self, nbytes: int):
        self.buf = torch.empty(max(nbytes, 1), dtype=torch.uint8)
        self.nbytes = self.buf.numel()
        torch.cuda.check_error(torch.cuda.cudart().cudaHostRegister(
            self.buf.data_ptr(), self.nbytes, 0))
        weakref.finalize(self, _unregister, self.buf)


def _unregister(buf):
    torch.cuda.synchronize()
    torch.cuda.check_error(
        torch.cuda.cudart().cudaHostUnregister(buf.data_ptr()))


def _pinned_empty_like(tree):
    """Empty pinned host tensors shaped like the leaves of ``tree``, all
    views of one exact-size :class:`_PinnedBlock`."""
    leaves = tree_leaves(tree)
    offs, n = [], 0
    for t in leaves:
        offs.append(n)
        n += -(-t.numel() * t.element_size() // _ALIGN) * _ALIGN
    block = _PinnedBlock(n)
    views = []
    for t, off in zip(leaves, offs):
        nb = t.numel() * t.element_size()
        v = block.buf[off:off + nb].view(t.dtype).view(t.shape)
        v._pinned_block = block      # keeps the registration alive
        views.append(v)
    it = iter(views)
    return tree_map(lambda _: next(it), tree)


def _leaves(tree):
    """The tensors of a nested dict or of lists and tuples of them."""
    if isinstance(tree, (list, tuple)):
        return [t for sub in tree for t in _leaves(sub)]
    return tree_leaves(tree)


def pinned_bytes(tree) -> int:
    """Bytes of the pinned blocks that back the tensors of ``tree`` (a
    nested dict, or lists of them: each block counted once); 0 where
    none is pinned."""
    blocks = {id(b): b for b in (getattr(t, "_pinned_block", None)
                                 for t in _leaves(tree)) if b is not None}
    return sum(b.nbytes for b in blocks.values())


def host_put(tree, device="cuda"):
    """A copy of ``tree`` in pinned host memory (one exact-size block for
    the whole tree) for the card ``device``; the copy is complete when
    this returns."""
    resolve_device(device)
    out = _pinned_empty_like(tree)
    tree_map(lambda h, t: h.copy_(t), out, tree)
    return out


def device_put_leaf(x, device="cuda"):
    """``x`` on ``device`` (an asynchronous copy from pinned memory)."""
    return x.to(resolve_device(device), non_blocking=True)


def _on_host(x, dev) -> bool:
    return dev.type == "cuda" and x.device.type == "cpu"


# ---------------------------------------------------------------------------
# gradient and moment offload
# ---------------------------------------------------------------------------
def init_offload_train_state(module, config, seed: int = 0,
                             optimizer: str = "adamw",
                             moment_dtype=torch.float32,
                             param_dtype=torch.float32,
                             offload_moments: bool = True, device="cuda"):
    """``module.init_train_state`` with the moment trees parked in pinned
    host memory (on a CUDA ``device``)."""
    state = module.init_train_state(
        config, seed, optimizer=optimizer, moment_dtype=moment_dtype,
        param_dtype=param_dtype, device=device)
    dev = resolve_device(device)
    if offload_moments and dev.type == "cuda":
        state.mu = host_put(state.mu, dev)
        state.nu = host_put(state.nu, dev)
    return state


def _grads_to_host(grads):
    """The gradient tree copied into pinned host memory (torch's caching
    host allocator: the buffers come back to it, and are reused, once the
    step no longer needs them) on the current stream."""
    def put(g):
        h = torch.empty(g.shape, dtype=g.dtype, pin_memory=True)
        return h.copy_(g, non_blocking=True)
    return tree_map(put, grads)


def make_offload_train_step(module, config, optimizer: str = "adamw",
                            lr=3e-4, beta1=0.9, beta2=0.95, eps=1e-8,
                            wd=0.1, clip_norm=1.0, loss_function=None,
                            offload_grads: bool = True,
                            offload_moments: bool = False,
                            adafactor_clip=1.0, adafactor_eps2=1e-3):
    """Build a two-phase host-offloaded train step for ``module`` (a model
    module of the port exposing ``loss_fn(params, tokens, config)`` and
    ``TrainState`` — llama or moe).

    Returns ``step(state, tokens) -> (state, loss)`` with the math of
    ``module.train_step`` (the same global-norm clip and per-leaf update),
    the gradients (``offload_grads``) staged through pinned host memory
    after the backward pass, and moments that lie in pinned host memory
    (``init_offload_train_state``) fetched per leaf and written back into
    their own buffers. Everything runs on the current stream, so each
    copy is ordered after what it reads. ``offload_moments`` is the JAX
    signature's flag; where the moments live is read from the state."""
    from ..models import llama as _llama

    lf = loss_function or module.loss_fn

    def step(state, tokens):
        params = state.params
        dev = tree_leaves(params)[0].device
        loss, grads = _llama.loss_and_grads(params, tokens, config, lf)
        gnorm = _llama.global_norm(grads)
        scale = (clip_norm / (gnorm + 1e-6)).clamp(max=1.0)
        if offload_grads and dev.type == "cuda":
            grads = _grads_to_host(grads)

        def fetch(x):
            return x.to(dev, non_blocking=True) if _on_host(x, dev) else x

        def home(old, new):
            # a moment leaf that lives on the host goes back into its
            # own pinned buffer
            return old.copy_(new, non_blocking=True) \
                if _on_host(old, dev) else new

        t = (state.step + 1).to(_f32)
        flat_p = tree_leaves(params)
        flat_g = tree_leaves(grads)
        with torch.no_grad():
            if optimizer == "adamw":
                bc1 = 1.0 - beta1 ** t
                bc2 = 1.0 - beta2 ** t
                outs = []
                for p, g, m, n in zip(flat_p, flat_g,
                                      tree_leaves(state.mu),
                                      tree_leaves(state.nu)):
                    np_, nm, nn = adamw_update(
                        p, fetch(g), fetch(m), fetch(n), lr=lr,
                        beta1=beta1, beta2=beta2, eps=eps, wd=wd,
                        scale=scale, bc1=bc1, bc2=bc2)
                    outs.append((np_, home(m, nm), home(n, nn)))
                new_p, new_mu, new_nu = (_unflatten(params, o)
                                         for o in zip(*outs))
                return module.TrainState(new_p, new_mu, new_nu,
                                         state.step + 1), loss
            if optimizer == "adafactor":
                beta2t = 1.0 - t ** -0.8
                outs = []
                for p, g, nu in zip(flat_p, flat_g,
                                    _leaf_subtrees(params, state.nu)):
                    np_, nnu = adafactor_update(
                        p, fetch(g), tree_map(fetch, nu), lr=lr,
                        beta2t=beta2t, eps1=1e-30, eps2=adafactor_eps2,
                        clip=adafactor_clip, wd=wd, scale=scale)
                    outs.append((np_, tree_map(home, nu, nnu)))
                new_p, new_nu = (_unflatten(params, o) for o in zip(*outs))
                return module.TrainState(new_p, state.mu, new_nu,
                                         state.step + 1), loss
        raise ValueError(f"unknown optimizer {optimizer!r}")

    return step


def _unflatten(params, items):
    """A tree like ``params`` holding ``items`` at its leaves, in
    :func:`tree_leaves` order."""
    it = iter(items)
    return tree_map(lambda _: next(it), params)


def _leaf_subtrees(params, tree):
    """The entries of ``tree`` at the leaves of ``params``, in
    :func:`tree_leaves` order (``flatten_up_to``)."""
    out = []
    tree_map(lambda _, sub: out.append(sub), params, tree)
    return out


# ---------------------------------------------------------------------------
# layer-wise optimizer-in-backward
# ---------------------------------------------------------------------------
def _adafactor(lr, wd, clip, eps2):
    """The per-leaf adafactor update of the layer-wise and streaming
    steps (no clip scale: no gradient tree to take a norm over)."""
    def fac(p, g, nu, beta2t):
        return adafactor_update(p, g, nu, lr=lr, beta2t=beta2t, eps1=1e-30,
                                eps2=eps2, clip=clip, wd=wd, scale=1.0)
    return fac


def _build_head_tail(c, fac):
    """The head-gradient and embed/norm/head-update functions shared by the
    layer-wise and streaming steps (identical math in both)."""
    from ..models import llama as _llama

    dt = c.dtype

    def head_loss(x_final, fn_w, head, targets):
        xn = _llama._rms_norm(x_final, fn_w, c.rms_eps)
        B, S, _ = xn.shape
        if c.loss_chunks > 1:
            total = _llama._chunked_ce_sum(xn, targets, head.to(dt),
                                           c.loss_chunks)
        else:
            total = _llama._ce_sum(xn, targets, head.to(dt))
        return total / (B * S)

    def head_grads(x_final, fn_w, head, targets):
        """(loss, (dx_final, d_final_norm, d_head))."""
        with torch.enable_grad():
            args = [t.detach().requires_grad_(True)
                    for t in (x_final, fn_w, head)]
            loss = head_loss(*args, targets)
            grads = torch.autograd.grad(loss, args)
        return loss.detach(), grads

    def tail_update(embed, fn_w, head, nu_e, nu_f, nu_h, tokens_in, dx0,
                    dfn, dhead, beta2t):
        h = embed.shape[1]
        d_embed = torch.zeros(embed.shape, dtype=_f32, device=embed.device)
        d_embed.index_add_(0, tokens_in.reshape(-1).long(),
                           dx0.reshape(-1, h).to(_f32))
        new_e, nnu_e = fac(embed, d_embed, nu_e, beta2t)
        del d_embed
        new_f, nnu_f = fac(fn_w, dfn, nu_f, beta2t)
        new_h, nnu_h = fac(head, dhead, nu_h, beta2t)
        return new_e, new_f, new_h, nnu_e, nnu_f, nnu_h

    return head_grads, tail_update


def _layer_vjp_update(body, lp, nu_l, x_in, dx, beta2t, fac, aux_cot=None):
    """Re-run one layer ``body(x, lp)`` from its saved input, take the
    gradients of its parameters and input for the output cotangent ``dx``
    (and ``aux_cot`` on an aux output, MoE), and apply ``fac`` to each
    parameter. Returns (new_lp, new_nu, dx_prev); a parameter the layer
    does not use gets a zero gradient (the JAX vjp's)."""
    with torch.enable_grad():
        lpt = {k: v.detach().requires_grad_(True) for k, v in lp.items()}
        xi = x_in.detach().requires_grad_(True)
        out = body(xi, lpt)
        if aux_cot is None:
            outs, cots = (out,), (dx,)
        else:
            outs, cots = out, (dx, aux_cot)
            if not outs[1].requires_grad:      # a dense layer: no aux
                outs, cots = outs[:1], cots[:1]
        grads = torch.autograd.grad(outs, [*lpt.values(), xi], cots,
                                    allow_unused=True)
        del out, outs
    *dlp, dx_prev = grads
    new_lp, new_nu = {}, {}
    for (k, p), g in zip(lp.items(), dlp):
        g = torch.zeros_like(p) if g is None else g
        new_lp[k], new_nu[k] = fac(p, g, nu_l[k], beta2t)
    return new_lp, new_nu, dx_prev


def _nu_like_perlayer(p):
    """Per-layer adafactor second-moment slot (factored for matrices)."""
    if p.dim() >= 2:
        return {"vr": torch.zeros(p.shape[:-1], dtype=_f32, device=p.device),
                "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=_f32,
                                  device=p.device)}
    return {"v": torch.zeros(p.shape, dtype=_f32, device=p.device)}


def _nu_layers_like(p):
    """A stacked [L, ...] leaf's per-layer slot: matrices factored over
    their trailing two dims with the stack dim kept, [L, h] norms a full
    {"v": [L, h]} (each layer's own second moment)."""
    if p.dim() - 1 >= 2:
        return _nu_like_perlayer(p)
    return {"v": torch.zeros(p.shape, dtype=_f32, device=p.device)}


def _layerwise_state(params):
    from ..models import llama as _llama

    nu = {k: (tree_map(_nu_layers_like, v) if k == "layers"
              else tree_map(_nu_like_perlayer, v))
          for k, v in params.items()}
    mu = tree_map(lambda p: torch.zeros((), dtype=_f32, device=p.device),
                  params)
    step = torch.zeros((), dtype=torch.int32,
                       device=params["embed"].device)
    return _llama.TrainState(params, mu, nu, step)


def init_layerwise_train_state(config, seed: int = 0,
                               param_dtype=torch.bfloat16, device="cuda"):
    """Train state for :func:`make_layerwise_train_step`: ``llama``'s
    parameters in ``param_dtype`` on ``device`` and adafactor's moments
    with PER-LAYER semantics: a stacked matmul weight [L, K, N] factors
    over (K, N) with the stack dim kept (as the fused path), a stacked
    norm [L, h] keeps a FULL per-layer second moment {"v": [L, h]};
    ``mu`` holds 0-d placeholders."""
    from ..models import llama as _llama

    return _layerwise_state(_llama.init_params(
        config, seed, device=device, dtype=param_dtype))


def _refuse(c, optimizer, what):
    """The JAX package's refusals of the layer-wise and streaming steps,
    with its messages."""
    if optimizer != "adafactor":
        why = (" (the no-first-moment optimizer is what makes per-layer "
               "in-place updates free)" if what == "layerwise" else "")
        raise NotImplementedError(f"{what} step supports adafactor{why}")
    if c.tie_embeddings:
        raise NotImplementedError(f"{what} step: untied embeddings only")
    if getattr(c, "pipeline_microbatches", 0):
        raise NotImplementedError(f"{what} step is a single-chip memory "
                                  "mode; use pipeline schedules on meshes")


def make_layerwise_train_step(config, optimizer: str = "adafactor",
                              lr=3e-4, wd=0.1, adafactor_clip=1.0,
                              adafactor_eps2=1e-3):
    """Optimizer-in-backward at LAYER granularity for llama-family configs.

    The fused step holds the parameters, the whole gradient tree and the
    new parameters at once. This step never forms the gradient tree: it
    runs the forward pass once without autograd (saving each layer's
    input), takes the loss's gradients with respect to the final hidden
    states, the final norm and the head, then walks the layers in
    REVERSE: it re-runs layer l's forward (``llama._layer_body``) from its
    saved input, takes the gradients of its weights and input, applies the
    adafactor update and writes the new weights and moments into the
    stacked tensors in place (the input state's layers ARE the output
    state's). A layer's gradients exist only during its own turn. The
    embedding, final norm and head update last (``d_embed`` an f32
    ``index_add_`` of the first layer's input gradient).

    Global-norm clipping is not available (it needs the full gradient
    tree); adafactor's update-RMS clip is the stabilizer. Tied embeddings
    and pipeline schedules raise. ``adafactor_eps2`` floors adafactor's
    step size (1e-3, the JAX package's value, by default).
    Returns ``step(state, tokens) -> (state, loss)``."""
    from ..models import llama as _llama

    c = config
    _refuse(c, optimizer, "layerwise")
    dt = c.dtype
    fac = _adafactor(lr, wd, adafactor_clip, adafactor_eps2)
    head_grads, tail_update = _build_head_tail(c, fac)

    @torch.no_grad()
    def step(state, tokens):
        params = state.params
        layers = params["layers"]
        nu = state.nu
        nu_layers = nu["layers"]
        t = (state.step + 1).to(_f32)
        beta2t = 1.0 - t ** -0.8
        inp = tokens[:, :-1]
        tgt = tokens[:, 1:]
        S = inp.shape[1]
        cos, sin = _llama._rope_tables(S, c.head_dim, c.rope_theta,
                                       tokens.device)

        def layer(l):
            return {k: v[l] for k, v in layers.items()}

        def body(x, lp):
            return _llama._layer_body(x, lp, cos, sin, c)

        x = params["embed"].to(dt)[inp.long()]
        xs = []
        for l in range(c.num_layers):
            xs.append(x)
            x = body(x, layer(l))
        loss, (dx, dfn, dhead) = head_grads(x, params["final_norm"],
                                            params["lm_head"], tgt)
        del x
        for l in range(c.num_layers - 1, -1, -1):
            nu_l = {k: {kk: vv[l] for kk, vv in v.items()}
                    for k, v in nu_layers.items()}
            new_lp, new_nu, dx = _layer_vjp_update(
                body, layer(l), nu_l, xs[l], dx, beta2t, fac)
            for k in new_lp:
                layers[k][l].copy_(new_lp[k])
                for kk, v in new_nu[k].items():
                    nu_layers[k][kk][l].copy_(v)
            xs[l] = None     # free the saved input
            del new_lp, new_nu
        new_e, new_f, new_h, nnu_e, nnu_f, nnu_h = tail_update(
            params["embed"], params["final_norm"], params["lm_head"],
            nu["embed"], nu["final_norm"], nu["lm_head"], inp, dx, dfn,
            dhead, beta2t)
        new_params = {"layers": layers, "embed": new_e,
                      "final_norm": new_f, "lm_head": new_h}
        new_nu = {"layers": nu_layers, "embed": nnu_e,
                  "final_norm": nnu_f, "lm_head": nnu_h}
        return _llama.TrainState(new_params, state.mu, new_nu,
                                 state.step + 1), loss

    return step


# ---------------------------------------------------------------------------
# host-streamed layer-wise step
# ---------------------------------------------------------------------------
class StreamTrainState:
    """Train state for :func:`make_streaming_train_step` and
    :func:`make_streaming_moe_train_step`.

    ``layers``/``nu_layers`` are *lists* of per-layer trees; on a CUDA
    device each layer's parameters and second moments lie in one
    exact-size pinned host block (on the CPU they are plain tensors).
    ``embed``/``final_norm``/``lm_head`` and their second moments stay on
    the device. ``step`` is a host int — the step loop is host-driven.
    ``parked`` holds, per layer, the CUDA event after which the layer's
    host block holds its last update (None: nothing pending); read the
    host blocks only after :meth:`synchronize`."""

    def __init__(self, layers, nu_layers, embed, final_norm, lm_head,
                 nu_embed, nu_fn, nu_head, step: int = 0, parked=None):
        self.layers = layers
        self.nu_layers = nu_layers
        self.embed = embed
        self.final_norm = final_norm
        self.lm_head = lm_head
        self.nu_embed = nu_embed
        self.nu_fn = nu_fn
        self.nu_head = nu_head
        self.step = int(step)
        self.parked = list(parked) if parked is not None \
            else [None] * len(layers)

    def synchronize(self):
        """Wait on the host until every layer's pending park is done."""
        for ev in self.parked:
            if ev is not None:
                ev.synchronize()


class _Streamer:
    """The streaming steps' host-to-device and device-to-host movers
    (shared by the llama and MoE variants — one place for transfer-path
    fixes). On a CUDA device fetches run on one copy stream and parks on
    another, so both directions of the link run at once, ordered against
    the compute stream by events; on the CPU both are identities."""

    def __init__(self, dev):
        self.dev = dev
        self.to_host = dev.type == "cuda"
        if self.to_host:
            self.h2d = torch.cuda.Stream(dev)
            self.d2h = torch.cuda.Stream(dev)

    def fetch(self, tree, parked=None):
        """Start copying a host tree to the device, after ``parked`` (the
        event of the last park into the same blocks). Returns a handle for
        :meth:`arrive`."""
        if not self.to_host:
            return tree, None
        with torch.cuda.stream(self.h2d):
            if parked is not None:
                self.h2d.wait_event(parked)
            out = tree_map(lambda t: t.to(self.dev, non_blocking=True), tree)
            done = torch.cuda.Event()
            done.record(self.h2d)
        return out, done

    def arrive(self, handle):
        """The fetched device tree, usable on the current stream: it waits
        for the copy, and the copy stream's blocks are not reused before
        this stream's work on them is done."""
        tree, done = handle
        if done is not None:
            compute = torch.cuda.current_stream(self.dev)
            compute.wait_event(done)
            for t in tree_leaves(tree):
                t.record_stream(compute)
        return tree

    def park(self, new, home):
        """Copy the device tree ``new`` into the host tree ``home`` after
        the current stream's work so far. Returns (home, event); on the
        CPU (new, None)."""
        if not self.to_host:
            return new, None
        compute = torch.cuda.current_stream(self.dev)
        self.d2h.wait_stream(compute)
        with torch.cuda.stream(self.d2h):
            tree_map(lambda h, n: h.copy_(n, non_blocking=True), home, new)
            done = torch.cuda.Event()
            done.record(self.d2h)
        for t in tree_leaves(new):
            t.record_stream(self.d2h)
        return home, done


def _park_layer(lp, nu, dev):
    """A freshly initialised layer's parameters and moments, each a tree,
    moved into one pinned block on a CUDA device (kept as they are on the
    CPU)."""
    if dev.type != "cuda":
        return lp, nu
    both = host_put({"p": lp, "nu": nu}, dev)
    return both["p"], both["nu"]


def _init_stream_state(layer_trees, embed, fn_w, head, dev):
    """A StreamTrainState from per-layer parameter trees (an iterable of
    device trees, each parked in its own pinned block as soon as it is
    made, so at most one layer is on the card at a time) and the tail."""
    layers, nu_layers = [], []
    for lp in layer_trees:
        lp, nl = _park_layer(lp, tree_map(_nu_like_perlayer, lp), dev)
        layers.append(lp)
        nu_layers.append(nl)
    return StreamTrainState(
        layers, nu_layers, embed, fn_w, head, _nu_like_perlayer(embed),
        _nu_like_perlayer(fn_w), _nu_like_perlayer(head), 0)


def _randn(gen, dev, dtype):
    """Scaled normals drawn in f32 from ``gen`` and cast to ``dtype``."""
    def g(shape, scale):
        return torch.randn(shape, generator=gen, dtype=_f32,
                           device=dev).mul_(scale).to(dtype)
    return g


def init_streaming_train_state(config, seed: int = 0,
                               param_dtype=torch.bfloat16, device="cuda"):
    """Init an 8B-class model without ever holding the full parameter set
    on the card: each layer is drawn on ``device`` (a ``torch.Generator``
    seeded with ``seed``) and, on a CUDA device, moved at once into its
    own pinned host block; the embedding, final norm and head stay on the
    device."""
    c = config
    if c.tie_embeddings:
        raise NotImplementedError("streaming step: untied embeddings only")
    h, f, L = c.hidden_size, c.intermediate_size, c.num_layers
    nq, nkv, d = c.num_heads, c.num_kv_heads, c.head_dim
    s = 1.0 / math.sqrt(h)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = _randn(gen, dev, param_dtype)

    def init_layer():
        return {
            "attn_norm": torch.ones((h,), dtype=param_dtype, device=dev),
            "wq": g((h, nq * d), s),
            "wk": g((h, nkv * d), s),
            "wv": g((h, nkv * d), s),
            "wo": g((nq * d, h), s / math.sqrt(2 * L)),
            "mlp_norm": torch.ones((h,), dtype=param_dtype, device=dev),
            "w_gate": g((h, f), s),
            "w_up": g((h, f), s),
            "w_down": g((f, h), 1.0 / math.sqrt(f) / math.sqrt(2 * L)),
        }

    layers = (init_layer() for _ in range(L))
    head = g((h, c.vocab_size), s)
    return _init_stream_state(
        layers, g((c.vocab_size, h), 1.0 / math.sqrt(h)),
        torch.ones((h,), dtype=param_dtype, device=dev), head, dev)


def streaming_state_from_layerwise(state, to_host: Optional[bool] = None):
    """Slice a stacked layer-wise TrainState into a StreamTrainState (used
    by tests for step equivalence and by checkpoint conversion): copies of
    each layer's parameters and second moments, in a pinned block per
    layer when ``to_host`` (the default on a CUDA state). The tail
    tensors are shared with ``state``."""
    params, nu = state.params, state.nu
    L = params["layers"]["wq"].shape[0]
    dev = params["embed"].device
    to_host = dev.type == "cuda" if to_host is None else to_host
    if to_host and dev.type != "cuda":
        raise ValueError("to_host=True needs a state on a CUDA device")
    layers, nu_layers = [], []
    for l in range(L):
        lp = tree_map(lambda a: a[l].clone(), params["layers"])
        nl = tree_map(lambda a: a[l].clone(), nu["layers"])
        if to_host:
            lp, nl = _park_layer(lp, nl, dev)
        layers.append(lp)
        nu_layers.append(nl)
    return StreamTrainState(
        layers, nu_layers, params["embed"], params["final_norm"],
        params["lm_head"], nu["embed"], nu["final_norm"], nu["lm_head"],
        int(state.step))


def layerwise_state_from_streaming(state):
    """Re-stack a StreamTrainState into the layer-wise TrainState layout on
    the device of its tail (for checkpoint save via the stacked-tree
    paths), after its pending parks."""
    from ..models import llama as _llama

    state.synchronize()
    dev = state.embed.device

    def stack(trees):
        return tree_map(lambda *xs: torch.stack([x.to(dev) for x in xs]),
                        *trees)

    params = {"layers": stack(state.layers), "embed": state.embed,
              "final_norm": state.final_norm, "lm_head": state.lm_head}
    nu = {"layers": stack(state.nu_layers), "embed": state.nu_embed,
          "final_norm": state.nu_fn, "lm_head": state.nu_head}
    mu = tree_map(lambda p: torch.zeros((), dtype=_f32, device=dev), params)
    return _llama.TrainState(params, mu, nu, torch.tensor(
        state.step, dtype=torch.int32, device=dev))


def _streaming_step(c, dev, fac, run, aux_coef=None):
    """The host-driven layer loop of both streaming steps. ``run(x, aux,
    lp, cos, sin, l)`` runs layer ``l`` and returns (x, aux); ``aux_coef``
    (MoE) is the router aux loss's weight: the loss is ce + coef * aux,
    and each layer's aux output gets the cotangent ``coef`` in its vjp."""
    from ..models import llama as _llama

    dt = c.dtype
    head_grads, tail_update = _build_head_tail(c, fac)
    mover = _Streamer(dev)

    @torch.no_grad()
    def step(state: StreamTrainState, tokens):
        L = c.num_layers
        inp = tokens[:, :-1]
        tgt = tokens[:, 1:]
        beta2t = 1.0 - float(state.step + 1) ** -0.8
        cos, sin = _llama._rope_tables(inp.shape[1], c.head_dim,
                                       c.rope_theta, tokens.device)
        parked = state.parked
        zero = torch.zeros((), dtype=_f32, device=tokens.device)

        # ---- forward: prefetch l+1 while l computes ---------------------
        xs = [None] * L
        x, aux = state.embed.to(dt)[inp.long()], zero
        nxt = mover.fetch(state.layers[0], parked[0])
        for l in range(L):
            cur, nxt = nxt, (mover.fetch(state.layers[l + 1], parked[l + 1])
                             if l + 1 < L else None)
            xs[l] = x
            x, aux = run(x, aux, mover.arrive(cur), cos, sin, l)
            cur = None      # the device copy goes once the layer is queued
        ce, (dx, dfn, dhead) = head_grads(x, state.final_norm,
                                          state.lm_head, tgt)
        del x

        # ---- backward: reverse walk, update, park back ------------------
        def home(l):
            return {"p": state.layers[l], "nu": state.nu_layers[l]}

        cot = None if aux_coef is None else torch.full(
            (), aux_coef, dtype=_f32, device=tokens.device)
        new_layers = list(state.layers)
        new_nu_layers = list(state.nu_layers)
        new_parked = list(parked)
        nxt = mover.fetch(home(L - 1), parked[L - 1])
        for l in range(L - 1, -1, -1):
            cur, nxt = nxt, (mover.fetch(home(l - 1), parked[l - 1])
                             if l > 0 else None)
            lay = mover.arrive(cur)

            def body(xi, lp, l=l):
                out = run(xi, zero, lp, cos, sin, l)
                return out[0] if cot is None else out

            new_lp, new_nu, dx = _layer_vjp_update(
                body, lay["p"], lay["nu"], xs[l], dx, beta2t, fac,
                aux_cot=cot)
            parked_l, new_parked[l] = mover.park(
                {"p": new_lp, "nu": new_nu}, home(l))
            new_layers[l], new_nu_layers[l] = parked_l["p"], parked_l["nu"]
            xs[l] = None    # free the saved input
            cur = lay = new_lp = new_nu = parked_l = None

        new_e, new_f, new_h, nnu_e, nnu_f, nnu_h = tail_update(
            state.embed, state.final_norm, state.lm_head,
            state.nu_embed, state.nu_fn, state.nu_head, inp, dx, dfn,
            dhead, beta2t)
        loss = ce if aux_coef is None else ce + aux_coef * aux
        return StreamTrainState(
            new_layers, new_nu_layers, new_e, new_f, new_h,
            nnu_e, nnu_f, nnu_h, state.step + 1, new_parked), loss

    return step


def make_streaming_train_step(config, optimizer: str = "adafactor",
                              lr=3e-4, wd=0.1, adafactor_clip=1.0,
                              adafactor_eps2=1e-3, device="cuda"):
    """Layer-wise optimizer-in-backward with **host-streamed parameters**:
    trains a model whose parameters, gradients and optimizer temporaries
    would not fit the card together (Llama-3-8B: 16 GB of bf16 weights).

    Mechanism — a host-driven layer loop and copies on two side streams:

    * each layer's parameters and second moments live in their own pinned
      host block (:class:`StreamTrainState`); the card holds the tail
      (embedding, final norm, head and their moments), the saved layer
      inputs and the few layers in flight;
    * forward: while layer *l* computes, layer *l+1* is copied in on the
      fetch stream; the compute stream waits for a layer's copy only when
      it starts that layer. Only each layer's *input* (B·S·h) is saved;
    * backward: layer *l-1* (with its moments) is copied in while layer
      *l* re-runs its forward, takes its gradients and applies the
      adafactor update; the updated layer is copied back into its pinned
      block on the park stream while *l-1* computes. A layer's gradients
      exist only during its own turn — no gradient tree, ever. The next
      step's fetch of a layer waits for this step's park of it.

    The link carries 3x the layers' parameter bytes a step (forward in,
    backward in, updated out) plus the second moments twice. Global-norm
    clipping is unavailable (no gradient tree); adafactor's update-RMS
    clip is the stabilizer. On the CPU (``device="cpu"``) the layers stay
    where they are and the step is the layer-wise step's math.
    Returns ``step(state, tokens) -> (state, loss)``."""
    from ..models import llama as _llama

    c = config
    _refuse(c, optimizer, "streaming")
    dev = resolve_device(device)
    fac = _adafactor(lr, wd, adafactor_clip, adafactor_eps2)

    def run(x, aux, lp, cos, sin, l):
        return _llama._layer_body(x, lp, cos, sin, c), aux

    return _streaming_step(c, dev, fac, run)


# ---------------------------------------------------------------------------
# host-streamed MoE step (DeepSeekMoE-16B at full depth on one card)
# ---------------------------------------------------------------------------
def init_streaming_moe_train_state(config, seed: int = 0,
                                   param_dtype=torch.bfloat16,
                                   device="cuda"):
    """Streaming state for MoE configs: each layer (attention, router,
    stacked experts and shared experts, ~1.2 GB at DeepSeekMoE-16B) is
    drawn on ``device`` and, on a CUDA device, moved at once into its own
    pinned host block — the full 33 GB parameter set never exists on the
    card. The ``first_dense_layers`` layers' trees leave out the router
    and the routed experts (they never touch them: no init, no pinned
    bytes, no traffic)."""
    c = config
    h, L, E = c.hidden_size, c.num_layers, c.num_experts
    nq, nkv, d = c.num_heads, c.num_kv_heads, c.head_dim
    fm = c.moe_intermediate_size
    fs = c.n_shared_experts * fm
    s = 1.0 / math.sqrt(h)
    o = s / math.sqrt(2 * L)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = _randn(gen, dev, param_dtype)

    def init_layer(dense):
        lp = {
            "attn_norm": torch.ones((h,), dtype=param_dtype, device=dev),
            "wq": g((h, nq * d), s),
            "wk": g((h, nkv * d), s),
            "wv": g((h, nkv * d), s),
            "wo": g((nq * d, h), o),
            "mlp_norm": torch.ones((h,), dtype=param_dtype, device=dev),
            "s_gate": g((h, fs), s),
            "s_up": g((h, fs), s),
            "s_down": g((fs, h), o),
        }
        if not dense:
            lp.update({
                "router": g((h, E), s),
                "e_gate": g((E, h, fm), s),
                "e_up": g((E, h, fm), s),
                "e_down": g((E, fm, h), o / math.sqrt(fm / h)),
            })
        return lp

    layers = (init_layer(l < c.first_dense_layers) for l in range(L))
    head = g((h, c.vocab_size), s)
    return _init_stream_state(
        layers, g((c.vocab_size, h), s),
        torch.ones((h,), dtype=param_dtype, device=dev), head, dev)


def make_streaming_moe_train_step(config, optimizer: str = "adafactor",
                                  lr=3e-4, wd=0.1, adafactor_clip=1.0,
                                  adafactor_eps2=1e-3, device="cuda"):
    """Host-streamed layer-wise train step for MoE configs — trains
    DeepSeekMoE-16B (33 GB of bf16 params) at full depth on one card, the
    MoE twin of :func:`make_streaming_train_step`.

    Same mechanism (pinned host residency, prefetch of the next layer,
    per-layer vjp and adafactor update, park back), plus the router aux
    loss: ``loss = CE + coef · Σ_l aux_l``, and each layer's aux
    contribution is LOCAL to that layer, so its gradient enters the
    layer's vjp as the constant cotangent ``coef`` on the layer's aux
    output — no cross-layer aux state is needed. Layers below
    ``first_dense_layers`` run the shared FFN alone (``moe._layer_body``
    with ``dense``). Returns ``step(state, tokens) -> (state, loss)``."""
    from ..models import moe as _moe

    c = config
    if optimizer != "adafactor":
        raise NotImplementedError("streaming step supports adafactor")
    if getattr(c, "context_parallel", False):
        raise NotImplementedError("streaming step is single-chip")
    dev = resolve_device(device)
    fac = _adafactor(lr, wd, adafactor_clip, adafactor_eps2)
    n_dense = c.first_dense_layers

    def run(x, aux, lp, cos, sin, l):
        return _moe._layer_body(x, aux, lp, cos, sin, c, l < n_dense)

    return _streaming_step(c, dev, fac, run,
                           aux_coef=float(c.router_aux_coef))


# ---------------------------------------------------------------------------
# states carried over from the JAX package
# ---------------------------------------------------------------------------
def _from_numpy(tree, device):
    from ..models import llama as _llama

    return tree_map(lambda a: _llama._leaf_from_numpy(a, device), tree)


def layerwise_state_from_numpy(params, nu, step: int = 0, device="cuda"):
    """The port's layer-wise TrainState from a JAX layer-wise state
    (``init_layerwise_train_state``'s layout) given as numpy arrays: the
    parameter tree (``llama.params_from_numpy``'s keys) and ``nu`` (same
    nesting, each leaf's {"vr", "vc"} or {"v"}) on ``device``, each array
    in its own dtype; ``mu`` 0-d placeholders; the step count ``step``."""
    from ..models import llama as _llama

    dev = resolve_device(device)
    p = _llama.params_from_numpy(params, device=dev)
    mu = tree_map(lambda t: torch.zeros((), dtype=_f32, device=dev), p)
    return _llama.TrainState(p, mu, _from_numpy(nu, dev), torch.tensor(
        step, dtype=torch.int32, device=dev))


def streaming_state_from_numpy(layers, nu_layers, embed, final_norm,
                               lm_head, nu_embed, nu_fn, nu_head,
                               step: int = 0, device="cuda"):
    """A StreamTrainState from a JAX one's fields as numpy arrays (llama or
    MoE layers: any per-layer trees): the layers and their second moments
    in a pinned block per layer on a CUDA ``device`` (plain CPU tensors on
    the CPU), the tail on ``device``."""
    dev = resolve_device(device)
    cpu = torch.device("cpu")
    ls, ns = [], []
    for lp, nl in zip(layers, nu_layers):
        lp, nl = _park_layer(_from_numpy(lp, cpu), _from_numpy(nl, cpu), dev)
        ls.append(lp)
        ns.append(nl)
    tail = [_from_numpy(t, dev) for t in (embed, final_norm, lm_head,
                                          nu_embed, nu_fn, nu_head)]
    return StreamTrainState(ls, ns, *tail, step=step)
