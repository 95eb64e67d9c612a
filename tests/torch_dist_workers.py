"""Multi-rank helpers for the port's CPU tests.

``spawn_ranks(fn, nprocs, workdir, *args)`` runs ``fn(rank, world, *args)``
in ``nprocs`` fresh processes joined in one gloo process group (a
``file://`` rendezvous under ``workdir``), and returns each rank's result,
rank order (``start_ranks`` starts them and returns at once). The rank workers live in this module, which imports torch and
the port but never jax, so a rank starts in about a second; a test module
runs one spawn for all its cases (a module-scoped fixture) and checks the
ranks' results against the JAX package in the test process.
"""
import datetime
import os
import pickle
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(rank, world, init_file, out_dir, fn, args):
    torch.set_num_threads(1)
    try:
        # a rank that dies leaves the others in a collective: time out
        dist.init_process_group("gloo", init_method=f"file://{init_file}",
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=120))
        try:
            res = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        payload = {"ok": res}
    except BaseException:        # the parent re-raises it with the trace
        payload = {"error": traceback.format_exc()}
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(payload, f)
    if "error" in payload:
        raise SystemExit(1)


class Ranks:
    """``fn(rank, world, *args)`` running on ``nprocs`` gloo ranks, started
    by :func:`start_ranks`; :meth:`results` waits for them."""

    def __init__(self, fn, nprocs, workdir, args):
        self.nprocs, self.workdir = nprocs, str(workdir)
        os.makedirs(self.workdir, exist_ok=True)
        init_file = os.path.join(self.workdir, "rdv")
        if os.path.exists(init_file):
            os.remove(init_file)
        self.ctx = mp.start_processes(
            _entry, args=(nprocs, init_file, self.workdir, fn, args),
            nprocs=nprocs, join=False, start_method="spawn")

    def results(self):
        """Each rank's result (picklable), rank order. A rank that raised
        fails the call with its traceback."""
        try:
            while not self.ctx.join():
                pass
        except mp.ProcessRaisedException as e:
            raise RuntimeError(f"a rank failed:\n{e}") from None
        except mp.ProcessExitedException:
            pass              # the rank's own traceback is in its file
        out = []
        for r in range(self.nprocs):
            with open(os.path.join(self.workdir, f"rank{r}.pkl"), "rb") as f:
                payload = pickle.load(f)
            if "error" in payload:
                raise RuntimeError(f"rank {r} failed:\n{payload['error']}")
            out.append(payload["ok"])
        return out


def start_ranks(fn, nprocs, workdir, *args):
    """Start ``fn(rank, world, *args)`` on ``nprocs`` gloo ranks and
    return at once (:class:`Ranks`), so the test process can compute its
    side meanwhile."""
    return Ranks(fn, nprocs, workdir, args)


def spawn_ranks(fn, nprocs, workdir, *args):
    """``fn(rank, world, *args)`` on ``nprocs`` gloo ranks; their results
    (picklable), rank order. A rank that raises fails the call with its
    traceback."""
    return start_ranks(fn, nprocs, workdir, *args).results()


def to_numpy(tree):
    """A tree of tensors as numpy (for the parent's comparisons)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return tree


def tp_mesh(world):
    """The CPU ``DeviceMesh`` of ``world`` ranks with the engine's dim."""
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh("cpu", list(range(world)), mesh_dim_names=("tp",))


def shard_last(a, world, rank):
    n = a.shape[-1] // world
    return np.ascontiguousarray(a[..., rank * n:(rank + 1) * n])


def shard_first(a, world, rank):
    n = a.shape[0] // world
    return np.ascontiguousarray(a[rank * n:(rank + 1) * n])


# ---------------------------------------------------------------------------
# tensor-parallel serving (tests/test_torch_tp_serving.py)
# ---------------------------------------------------------------------------
def port_params(tree, kind):
    """A numpy parameter tree (f32; int8 leaves' scales widened to f32)
    as the port's: ``kind`` "f32", "bf16" or "int8w"."""
    from paddle_tpu_torch.models import llama as tl

    dtype = torch.bfloat16 if kind == "bf16" else None
    params = tl.params_from_numpy(tree, device="cpu", dtype=dtype)
    if kind == "int8w":
        for leaf in list(params["layers"].values()) + [params.get("lm_head")]:
            if isinstance(leaf, dict):
                leaf["s"] = leaf["s"].to(torch.bfloat16)
    return params


def serve_case(params, cfg, case, mesh=None):
    """One serving workload of the tp tests: (streams, engine)."""
    from paddle_tpu_torch.serving import LLMEngine

    kw = dict(case["engine"])
    if case.get("spec"):
        kw.update(draft_params=params, draft_config=cfg,
                  spec_tokens=case["spec"])
    eng = LLMEngine(params, cfg, device="cpu", mesh=mesh, **kw)
    streams = []
    for _ in range(case.get("rounds", 1)):
        ids = [eng.add_request(list(p), max_new_tokens=k)
               for p, k in zip(case["prompts"], case["n_new"])]
        out = eng.run()
        streams += [out[i] for i in ids]
    return streams, eng


def tp_serving_worker(rank, world, trees, cfg_kw, cases, b4):
    import dataclasses

    from paddle_tpu_torch.kernels import mega_decode as tmd
    from paddle_tpu_torch.kernels import paged_attention as tpa
    from paddle_tpu_torch.models import llama as tl
    from paddle_tpu_torch.serving import LLMEngine

    mesh = tp_mesh(world)
    out = {"cases": {}}
    for name, case in cases.items():
        kind = case["params"]
        cfg = dataclasses.replace(
            tl.tiny_llama(**cfg_kw),
            dtype=torch.bfloat16 if kind == "bf16" else torch.float32)
        params = port_params(trees["int8w" if kind == "int8w" else "f32"],
                             kind)
        streams, eng = serve_case(params, cfg, case, mesh)
        out["cases"][name] = dict(
            streams=streams, collectives=dict(eng.tp_collectives),
            readbacks=dict(eng.readbacks),
            decode_paths=dict(eng.decode_paths),
            mega_fallbacks=dict(eng.mega_fallbacks),
            spec_waves=eng.spec_waves,
            prefix_hits=(eng.prefix_cache.hits
                         if eng.prefix_cache is not None else None),
            pools={k: tuple(v.shape) for k, v in eng.pools.items()},
            wq=tuple(eng.params["layers"]["wq"]["q"].shape
                     if kind == "int8w" else
                     eng.params["layers"]["wq"].shape))
    cfg = dataclasses.replace(tl.tiny_llama(**cfg_kw), dtype=torch.float32)
    params = port_params(trees["f32"], "f32")
    qparams = port_params(trees["int8w"], "int8w")
    out["shards"] = to_numpy(tl.shard_params(
        qparams, tl.make_serving_shardings(qparams, cfg, mesh, fsdp=False),
        mesh))
    out["mega_screen"] = tmd.mega_supported(
        params, cfg, n_slots=2, n_steps=3, block_size=8, kv_int8=False,
        mesh=mesh)
    # the reference's refusal: tp must divide the kv heads
    odd = dataclasses.replace(cfg, num_heads=3, num_kv_heads=3,
                              head_dim=8, hidden_size=24)
    try:
        LLMEngine(tl.init_params(odd, seed=0, device="cpu"), odd,
                  device="cpu", mesh=mesh)
        out["odd_heads"] = None
    except ValueError as e:
        out["odd_heads"] = str(e)
    # a process group that cannot carry the engine's tensors raises at
    # construction (the probe all-reduce), never mid-stream
    orig = tl.TPPlan.reduce

    def refuse(self, y):
        raise RuntimeError("this backend takes no such tensor")
    tl.TPPlan.reduce = refuse
    try:
        LLMEngine(params, cfg, device="cpu", mesh=mesh)
        out["no_carry"] = None
    except RuntimeError as e:
        out["no_carry"] = str(e)
    finally:
        tl.TPPlan.reduce = orig
    # B4's tp form on this rank's kv-head slice, bf16/f32 and int8 pools
    out["b4"] = {}
    for form, arrs in b4.items():
        q, kp, vp, table, lens = (torch.as_tensor(a) for a in arrs[:5])
        if form == "bf16":
            q, kp, vp = (t.to(torch.bfloat16) for t in (q, kp, vp))
        kw = {}
        if len(arrs) > 5:
            kw = {n: tpa.shard_kv_heads(torch.as_tensor(a), world, rank, 3)
                  for n, a in zip(("ks_pool", "vs_pool"), arrs[5:])}
        acc, m, l = tpa.ragged_decode_partial(
            tpa.shard_kv_heads(q, world, rank, 1),
            tpa.shard_kv_heads(kp, world, rank, 3),
            tpa.shard_kv_heads(vp, world, rank, 3), table, lens,
            layer=1, mesh=mesh, **kw)
        out["b4"][form] = to_numpy((acc, m, l))
    return out


# ---------------------------------------------------------------------------
# collectives (tests/test_torch_collective.py)
# ---------------------------------------------------------------------------
def rank_input(r):
    """Rank r's input tensor of the collective tests."""
    return torch.arange(6, dtype=torch.float32).reshape(2, 3) * (r + 1) + r


def collective_worker(rank, world):
    from paddle_tpu_torch import distributed as pd
    from paddle_tpu_torch.distributed import stream
    from paddle_tpu_torch.distributed.store import TCPStore

    R = pd.ReduceOp
    out = {"env": (pd.get_rank(), pd.get_world_size(), pd.is_initialized(),
                   pd.ParallelEnv().nranks, pd.get_backend(),
                   pd.device_world_size())}
    for name in ("SUM", "MAX", "MIN", "PROD", "AVG"):
        t = rank_input(rank)
        pd.all_reduce(t, getattr(R, name))
        out["all_reduce_" + name] = t.numpy()
    lst = []
    pd.all_gather(lst, rank_input(rank))
    out["all_gather"] = [t.numpy() for t in lst]
    objs = []
    pd.all_gather_object(objs, {"rank": rank})
    out["all_gather_object"] = objs
    t = rank_input(rank)
    pd.broadcast(t, src=world - 1)
    out["broadcast"] = t.numpy()
    t = rank_input(rank)
    pd.reduce(t, dst=0)
    out["reduce"] = t.numpy()
    t = torch.zeros(2)
    pd.scatter(t, [torch.full((2,), 10.0 * i) for i in range(world)]
               if rank == 0 else None, src=0)
    out["scatter"] = t.numpy()
    t = torch.zeros(2)
    pd.reduce_scatter(t, [torch.full((2,), float((rank + 1) * (i + 1)))
                          for i in range(world)])
    out["reduce_scatter"] = t.numpy()
    lst = []
    pd.all_to_all(lst, [torch.full((j + 1, 2), 100.0 * rank + j)
                        for j in range(world)])
    out["all_to_all"] = [t.numpy() for t in lst]
    lst = []
    pd.alltoall(lst, [torch.full((1,), 10.0 * rank + j) for j in range(world)])
    out["alltoall"] = [t.numpy() for t in lst]
    t = torch.empty(2 * world)
    pd.alltoall_single(t, torch.arange(2 * world, dtype=torch.float32)
                       + 10 * rank)
    out["alltoall_single"] = t.numpy()
    # point to point around the ring (even ranks send first)
    nxt, prv = (rank + 1) % world, (rank - 1) % world
    got = torch.zeros(3)
    if rank % 2 == 0:
        pd.send(torch.full((3,), float(rank)), dst=nxt)
        pd.recv(got, src=prv)
    else:
        pd.recv(got, src=prv)
        pd.send(torch.full((3,), float(rank)), dst=nxt)
    out["send_recv"] = got.numpy()
    got = torch.zeros(3)
    tasks = [pd.isend(torch.full((3,), rank + 0.5), nxt),
             pd.irecv(got, prv)]
    for task in tasks:
        task.wait()
    out["isend_irecv"] = got.numpy()
    lst = []
    pd.gather(rank_input(rank), lst, dst=0)
    out["gather"] = [t.numpy() for t in lst]
    objs = [f"from{rank}", rank]
    pd.broadcast_object_list(objs, src=1)
    out["broadcast_object_list"] = objs
    objs = []
    pd.scatter_object_list(objs, [f"to{i}" for i in range(world)]
                           if rank == 0 else None, src=0)
    out["scatter_object_list"] = objs
    pd.barrier()
    pd.wait(rank_input(rank))
    # the sharded train step's gather and reduce-scatter along a dim
    # (point to point on gloo), f32 and bf16
    from paddle_tpu_torch.distributed import collective as pdc

    t = rank_input(rank)
    out["all_gather_dim"] = [pdc.all_gather_dim(t, d).numpy()
                             for d in (0, 1)]
    big = torch.arange(4 * world * 3, dtype=torch.float32).reshape(
        4 * world, 3) * (rank + 1)
    out["reduce_scatter_dim"] = [
        pdc.reduce_scatter_dim(big, 0).numpy(),
        pdc.reduce_scatter_dim(big.t().contiguous(), 1).numpy(),
        pdc.reduce_scatter_dim(big.to(torch.bfloat16), 0).float().numpy()]
    # subgroups: every rank creates every group, in the same order
    groups = [pd.new_group([0, 1])]
    if world == 4:
        groups.append(pd.new_group([1, 3]))
    sub = []
    for g in groups:
        t = rank_input(rank)
        pd.all_reduce(t, group=g)
        lst = []
        pd.all_gather(lst, torch.tensor([float(rank)]), group=g)
        t2 = torch.tensor([float(rank)])
        pd.broadcast(t2, src=g.ranks[-1], group=g)
        sub.append((g.ranks, g.rank, g.is_member(), t.numpy(),
                    [x.numpy() for x in lst], t2.numpy()))
    out["subgroups"] = sub
    # the stream variants
    st = {}
    t = rank_input(rank)
    task = stream.all_reduce(t, op=R.MAX, sync_op=False,
                             use_calc_stream=True)
    task.wait()
    st["all_reduce"] = t.numpy()
    lst = []
    stream.all_gather(lst, rank_input(rank)).wait()
    st["all_gather"] = [x.numpy() for x in lst]
    t = rank_input(rank)
    stream.broadcast(t, src=0).wait()
    st["broadcast"] = t.numpy()
    t = rank_input(rank)
    stream.reduce(t, dst=0, op=R.MIN).wait()
    st["reduce"] = t.numpy()
    t = torch.zeros(2)
    stream.reduce_scatter(t, [torch.full((2,), float(rank + i))
                              for i in range(world)]).wait()
    st["reduce_scatter"] = t.numpy()
    t = torch.zeros(2)
    stream.scatter(t, [torch.full((2,), 7.0 * i) for i in range(world)]
                   if rank == 1 else None, src=1).wait()
    st["scatter"] = t.numpy()
    t = torch.empty(2 * world)
    stream.alltoall_single(t, torch.arange(2 * world, dtype=torch.float32)
                           + 10 * rank).wait()
    st["alltoall_single"] = t.numpy()
    lst = []
    stream.alltoall(lst, [torch.full((1,), 10.0 * rank + j)
                          for j in range(world)]).wait()
    st["alltoall"] = [x.numpy() for x in lst]
    lst = []
    stream.gather(rank_input(rank), lst, dst=1).wait()
    st["gather"] = [x.numpy() for x in lst]
    got = torch.zeros(2)
    if rank == 0:
        stream.send(torch.full((2,), 5.0), dst=1).wait()
    elif rank == 1:
        stream.recv(got, src=0).wait()
    st["send_recv"] = got.numpy()
    out["stream"] = st
    # the store across ranks: rank 0 serves, everyone connects
    port = [None]
    if rank == 0:
        master = TCPStore("127.0.0.1", 0, is_master=True, world_size=world)
        port = [master.port]
    pd.broadcast_object_list(port, src=0)
    client = TCPStore("127.0.0.1", port[0], world_size=world)
    out["store_gather"] = client.gather("g", rank, world, f"v{rank}")
    out["store_add"] = client.add("ctr", rank + 1)
    client.barrier("b", world)
    out["store_total"] = client.add("ctr", 0)
    client.barrier("b2", world)      # the master outlives every reader
    pd.barrier()
    return out


def spawn_target(out_dir, fail_rank=-1):
    """A rank started by ``paddle_tpu_torch.distributed.spawn``: brings its
    process group up from the env contract, all-reduces its rank and
    writes what it saw."""
    import json

    from paddle_tpu_torch import distributed as pd

    pd.init_parallel_env()
    rank = pd.get_rank()
    if rank == fail_rank:
        raise RuntimeError(f"rank {rank} fails on purpose")
    t = torch.tensor([float(rank + 1)])
    pd.all_reduce(t)
    with open(os.path.join(out_dir, f"spawned{rank}.json"), "w") as f:
        json.dump({"rank": rank, "world": pd.get_world_size(),
                   "backend": pd.get_backend(), "sum": float(t[0]),
                   "master": os.environ["PADDLE_MASTER"]}, f)
    pd.destroy_process_group()


# ---------------------------------------------------------------------------
# the hybrid topology (tests/test_torch_hcg.py)
# ---------------------------------------------------------------------------
def hcg_worker(rank, world, strategies):
    from paddle_tpu_torch.distributed import all_reduce, fleet

    out = []
    for hc in strategies:
        strategy = fleet.DistributedStrategy()
        strategy.hybrid_configs = dict(strategy.hybrid_configs, **hc)
        fleet.init(is_collective=True, strategy=strategy)
        hcg = fleet.get_hybrid_communicate_group()
        groups = {
            "dp": hcg.get_data_parallel_group(),
            "mp": hcg.get_model_parallel_group(),
            "pp": hcg.get_pipe_parallel_group(),
            "sharding": hcg.get_sharding_parallel_group(),
            "sep": hcg.get_sep_parallel_group()}
        sums = {}
        for name, g in groups.items():
            t = torch.tensor([float(rank)])
            all_reduce(t, group=g)
            sums[name] = float(t[0])
        mesh = hcg.device_mesh
        out.append(dict(
            degrees=(hcg.get_data_parallel_world_size(),
                     hcg.get_pipe_parallel_world_size(),
                     hcg.get_sharding_parallel_world_size(),
                     hcg.get_sep_parallel_world_size(),
                     hcg.get_model_parallel_world_size()),
            ranks=(hcg.get_data_parallel_rank(), hcg.get_stage_id(),
                   hcg.get_sharding_parallel_rank(),
                   hcg.get_sep_parallel_rank(),
                   hcg.get_model_parallel_rank()),
            groups={k: g.ranks for k, g in groups.items()},
            sums=sums,
            src=(hcg.get_data_parallel_group_src_rank(),
                 hcg.get_model_parallel_group_src_rank()),
            first_last=(hcg.is_first_stage(), hcg.is_last_stage()),
            mesh=(tuple(mesh.mesh_dim_names), tuple(mesh.shape),
                  {n: sorted(dist.get_process_group_ranks(
                      mesh.get_group(n))) for n in mesh.mesh_dim_names}),
            worker=(fleet.worker_index(), fleet.worker_num(),
                    fleet.is_first_worker()),
            util=(fleet.UtilBase().all_reduce([rank, 1], mode="sum").tolist(),
                  fleet.UtilBase().all_reduce([rank], mode="max").tolist(),
                  fleet.UtilBase().all_gather(rank))))
        out[-1]["wrapped"] = fleet_wrappers(fleet, hcg)
        fleet.barrier_worker()
        fleet.UtilBase().barrier()
    errors = []
    for call in (lambda: fleet.fleet.init_server(),
                 lambda: fleet.fleet.run_server(),
                 lambda: fleet.fleet.init_worker()):
        try:
            call()
        except NotImplementedError as e:
            errors.append(str(e))
    return {"inits": out, "errors": errors}


def fleet_wrappers(fleet, hcg):
    """What ``distributed_model`` and ``distributed_optimizer`` make of a
    small module and its SGD under the hybrid group: the wrappers' class
    names and groups, or the error a wrapper raises."""
    model = torch.nn.Linear(4, 2)
    try:
        m = fleet.distributed_model(model)
        got = {"model": type(m).__name__, "inner": m is model or
               getattr(m, "_layers", None) is model,
               "group": (m._group.ranks if getattr(m, "_group", None)
                         is not None else None)}
    except NotImplementedError as e:
        got = {"model_error": str(e)}
    opt = fleet.distributed_optimizer(
        torch.optim.SGD(model.parameters(), lr=0.1))
    got["optimizer"] = (type(opt).__name__, opt._hcg is hcg,
                        type(opt._inner_opt).__name__)
    return got


# ---------------------------------------------------------------------------
# the mpu layers (tests/test_torch_mpu.py)
# ---------------------------------------------------------------------------
def mpu_worker(rank, world, data):
    """Each layer with this rank's shard of the numpy weights, forward and
    backward against the upstream gradient; outputs, input gradients and
    this rank's weight gradients."""
    from paddle_tpu_torch.distributed.fleet.layers import mpu
    from paddle_tpu_torch.distributed.fleet.layers.mpu import mp_ops

    out = {}

    def grads(layer, x, y, g):
        (y * torch.as_tensor(g)).sum().backward()
        return dict(y=y.detach().numpy(), gx=x.grad.numpy(),
                    gw=layer.weight.grad.numpy(),
                    gb=(layer.bias.grad.numpy()
                        if getattr(layer, "bias", None) is not None
                        else None))

    for gather in (True, False):
        d = data["column"]
        lay = mpu.ColumnParallelLinear(*d["w"].shape, gather_output=gather)
        with torch.no_grad():
            lay.weight.copy_(torch.as_tensor(shard_last(d["w"], world, rank)))
            lay.bias.copy_(torch.as_tensor(shard_last(d["b"], world, rank)))
        x = torch.as_tensor(d["x"]).requires_grad_()
        y = lay(x)
        g = d["g"] if gather else shard_last(d["g"], world, rank)
        out[f"column_{gather}"] = grads(lay, x, y, g)
    for parallel in (False, True):
        d = data["row"]
        lay = mpu.RowParallelLinear(*d["w"].shape, input_is_parallel=parallel)
        with torch.no_grad():
            lay.weight.copy_(torch.as_tensor(shard_first(d["w"], world,
                                                         rank)))
            lay.bias.copy_(torch.as_tensor(d["b"]))
        xin = shard_last(d["x"], world, rank) if parallel else d["x"]
        x = torch.as_tensor(xin).requires_grad_()
        out[f"row_{parallel}"] = grads(lay, x, lay(x), d["g"])
    d = data["embed"]
    lay = mpu.VocabParallelEmbedding(*d["w"].shape)
    with torch.no_grad():
        lay.weight.copy_(torch.as_tensor(shard_first(d["w"], world, rank)))
    y = lay(torch.as_tensor(d["ids"]))
    (y * torch.as_tensor(d["g"])).sum().backward()
    out["embed"] = dict(y=y.detach().numpy(), gw=lay.weight.grad.numpy())
    d = data["ce"]
    ce = mpu.ParallelCrossEntropy(ignore_index=d["ignore"])
    logits = torch.as_tensor(shard_last(d["logits"], world, rank)) \
        .requires_grad_()
    loss = ce(logits, torch.as_tensor(d["label"]))
    (loss * torch.as_tensor(d["g"])).sum().backward()
    out["ce"] = dict(y=loss.detach().numpy(), gx=logits.grad.numpy())
    # the ops on their own: split/concat/identity/allreduce round trips
    x = torch.arange(8, dtype=torch.float32).reshape(2, 4) + rank
    x.requires_grad_()
    y = mp_ops._c_concat(mp_ops._c_split(x))
    (y * (rank + 1)).sum().backward()
    out["split_concat"] = (y.detach().numpy(), x.grad.numpy())
    x = torch.ones(2, requires_grad=True)
    y = mp_ops._c_identity(x) * (rank + 1)
    y.sum().backward()
    z = mp_ops._mp_allreduce(torch.full((2,), float(rank + 1)))
    out["identity_allreduce"] = (x.grad.numpy(), z.numpy())
    # the model-parallel RNG: one seed, a distinct stream a rank
    from paddle_tpu_torch.distributed.fleet.layers.mpu import random as mpr

    mpr.model_parallel_random_seed(1234)
    outside = torch.rand(3)
    with mpr.get_rng_state_tracker().rng_state():
        inside = torch.rand(3)
    with mpr.get_rng_state_tracker().rng_state():
        inside2 = torch.rand(3)
    out["rng"] = (outside.numpy(), inside.numpy(), inside2.numpy(),
                  torch.rand(3).numpy())
    return out


# ---------------------------------------------------------------------------
# sharded training (tests/test_torch_sharded_train.py,
# tests/test_torch_moe_sharded.py)
# ---------------------------------------------------------------------------
TRAIN_AXES = ("dp", "sp", "tp")


TRAIN_MESHES = {}


def train_mesh(world, dp, tp):
    """The CPU ``DeviceMesh`` (dp, sp=1, tp) over the world's ranks, one a
    shape kept in ``TRAIN_MESHES`` (every rank makes the meshes in the
    same order)."""
    from torch.distributed.device_mesh import DeviceMesh

    key = (world, dp, tp)
    if key not in TRAIN_MESHES:
        TRAIN_MESHES[key] = DeviceMesh(
            "cpu", torch.arange(world).reshape(dp, 1, tp),
            mesh_dim_names=TRAIN_AXES)
    return TRAIN_MESHES[key]


def mesh_coords(rank, dp, tp):
    """Rank ``rank``'s coordinates on ``train_mesh``'s (dp, 1, tp)."""
    return {"dp": rank // tp, "sp": 0, "tp": rank % tp}


def _train_model(case):
    from paddle_tpu_torch.models import llama as tl
    from paddle_tpu_torch.models import moe as tm

    return (tm, tm.loss_fn) if case.get("model") == "moe" else (tl, None)


def _spec_tree(tree):
    if isinstance(tree, dict):
        return {k: _spec_tree(v) for k, v in tree.items()}
    return tuple(tree)


def sharded_train_case(rank, world, tree, toks, cfg, case):
    """One case of the sharded-train tests on this rank: the whole numpy
    state cut by the case's shardings, then ``steps`` train steps on this
    rank's rows, each after a ``loss_and_grads`` and the plan's global
    norm; the losses, norms, final slices, specs and the plan's
    collectives."""
    import dataclasses

    from paddle_tpu_torch.models import llama as tl
    from paddle_tpu_torch.optimizer import functional as tf

    mod, lf = _train_model(case)
    cfg = dataclasses.replace(cfg, **case.get("config", {}))
    dp, tp = case["mesh"]
    mesh = train_mesh(world, dp, tp)
    opt = case["optimizer"]
    params = mod.params_from_numpy(tree, device="cpu")
    mu, nu = tf.init_moments(params, opt)
    state = tl.TrainState(params, mu, nu, torch.zeros((), dtype=torch.int32))
    sh = mod.make_shardings(cfg, mesh, fsdp=case["fsdp"])
    out = {"losses": [], "gnorms": [], "coords": mesh_coords(rank, dp, tp),
           "specs": _spec_tree(sh)}
    with tl.activation_mesh(mesh):
        state = tl.put_train_state(state, sh, opt)
        rows = tl.shard_batch(torch.as_tensor(toks))
        if case.get("aux"):
            _, aux = mod.forward(state.params, rows[:, :-1], cfg,
                                 return_aux=True)
            out["aux"] = float(aux)
        for _ in range(case.get("steps", 2)):
            _, grads = tl.loss_and_grads(state.params, rows, cfg, lf)
            plan = tl.train_plan(cfg, state.params)
            out["gnorms"].append(float(plan.global_norm(grads)))
            state, loss = mod.train_step(
                state, rows, cfg, lr=case.get("lr", 3e-4), optimizer=opt,
                accum_steps=case.get("accum", 1))
            out["losses"].append(float(loss))
        plan = tl.train_plan(cfg, state.params)
        out["counts"] = dict(plan.counts)
        out["plan_steps"] = plan.steps
        out["local_config"] = (plan.config.num_heads, plan.config.num_kv_heads)
    mu_sh, nu_sh = tf.moment_shardings(sh, state.params, opt)
    out["moment_specs"] = (_spec_tree(mu_sh), _spec_tree(nu_sh))
    out["state"] = to_numpy({"params": state.params, "mu": state.mu,
                             "nu": state.nu})
    return out


def sharded_init_check(rank, world, cfg, case):
    """``init_sharded_train_state`` against ``shard_params(init_params)``
    (bit for bit) and ``put_train_state``'s moments (shapes), for one
    model, mesh, fsdp and optimizer."""
    from paddle_tpu_torch.models import llama as tl
    from paddle_tpu_torch.optimizer import functional as tf

    mod, _ = _train_model(case)
    dp, tp = case["mesh"]
    mesh = train_mesh(world, dp, tp)
    opt = case["optimizer"]
    sh = mod.make_shardings(cfg, mesh, fsdp=case["fsdp"])
    st = mod.init_sharded_train_state(cfg, 3, sh, opt, device="cpu",
                                      mesh=mesh)
    whole = mod.init_params(cfg, 3, device="cpu")
    want = tl.shard_params(whole, sh, mesh)
    mu, nu = tf.init_moments(whole, opt)
    put = tl.put_train_state(tl.TrainState(whole, mu, nu, st.step), sh, opt,
                             mesh=mesh)
    equal = all(torch.equal(a, b) for a, b in zip(
        tf.tree_leaves(st.params), tf.tree_leaves(want)))
    shapes = [tuple(t.shape)
              for t in tf.tree_leaves({"mu": st.mu, "nu": st.nu})]
    put_shapes = [tuple(t.shape)
                  for t in tf.tree_leaves({"mu": put.mu, "nu": put.nu})]
    cut = any(a.shape != b.shape for a, b in zip(
        tf.tree_leaves(st.params), tf.tree_leaves(whole)))
    return {"equal": equal, "moment_shapes": shapes == put_shapes,
            "cut": cut, "step": int(st.step)}


def sharded_train_worker(rank, world, tree, toks, cfg, cases, inits,
                         refusals=()):
    """Every case of a sharded-train test module on this rank (module
    docstrings of the tests), the init checks, and the refusals: each
    ``(mesh shape, axes, config)`` of ``refusals`` with the error a train
    step raises under it."""
    from torch.distributed.device_mesh import DeviceMesh

    from paddle_tpu_torch.models import llama as tl
    from paddle_tpu_torch.optimizer import functional as tf

    out = {"cases": {name: sharded_train_case(rank, world, tree, toks, cfg,
                                               case)
                     for name, case in cases.items()},
           "inits": {name: sharded_init_check(rank, world, cfg, case)
                     for name, case in inits.items()},
           "refusals": []}
    for shape, axes, model in refusals:
        mesh = DeviceMesh("cpu", torch.arange(world).reshape(shape),
                          mesh_dim_names=axes)
        mod, lf = _train_model({"model": model})
        c = cfg if model != "moe" else _moe_refusal_config()
        params = mod.init_params(c, 0, device="cpu")
        mu, nu = tf.init_moments(params)
        st = tl.TrainState(params, mu, nu, torch.zeros((), dtype=torch.int32))
        try:
            with tl.activation_mesh(mesh):
                mod.train_step(st, torch.as_tensor(toks), c)
            out["refusals"].append(None)
        except NotImplementedError as e:
            out["refusals"].append(str(e))
    return out


def _moe_refusal_config():
    from paddle_tpu_torch.models import moe as tm

    return tm.tiny_moe(vocab=64, hidden=32, layers=1, heads=4, experts=4,
                       seq=64)


# ---------------------------------------------------------------------------
# the eager data-parallel wrappers (tests/test_torch_data_parallel.py)
# ---------------------------------------------------------------------------
def mlp_from_numpy(w):
    """Linear(8, 16) -> tanh -> Linear(16, 4) with the numpy weights
    ``w`` (torch's [out, in] layout)."""
    m = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Tanh(),
                            torch.nn.Linear(16, 4))
    with torch.no_grad():
        for (name, p), a in zip(m.named_parameters(), w):
            p.copy_(torch.as_tensor(a))
    return m


def mlp_loss(m, x, t):
    return ((m(torch.as_tensor(x)) - torch.as_tensor(t)) ** 2).mean()


def data_parallel_worker(rank, world, w, x, t, lr):
    """DataParallel's averaged grads on this rank's rows, its no_sync
    grads, and fleet's wrappers (dp=2): one HybridParallelOptimizer step
    and one ``minimize``, with the pass-throughs."""
    from paddle_tpu_torch.distributed import DataParallel, fleet

    n = x.shape[0] // world
    rows = slice(rank * n, (rank + 1) * n)
    out = {}
    dpm = DataParallel(mlp_from_numpy(w))
    mlp_loss(dpm, x[rows], t[rows]).backward()
    dpm.apply_collective_grads()
    out["avg"] = [p.grad.numpy().copy() for p in dpm.parameters()]
    for p in dpm.parameters():
        p.grad = None
    with dpm.no_sync():
        mlp_loss(dpm, x[rows], t[rows]).backward()
        dpm.apply_collective_grads()
    out["no_sync"] = [p.grad.numpy().copy() for p in dpm.parameters()]
    out["names"] = (list(dpm.state_dict()), [k for k, _ in
                                             dpm.named_parameters()])

    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = dict(strategy.hybrid_configs, dp_degree=world)
    fleet.init(is_collective=True, strategy=strategy)
    model = fleet.distributed_model(mlp_from_numpy(w))
    opt = fleet.distributed_optimizer(
        torch.optim.SGD(model.parameters(), lr=lr))
    out["wrappers"] = (type(model).__name__, model._group.ranks,
                       type(opt).__name__)
    # the model's own backward is local: the optimizer averages
    mlp_loss(model._layers, x[rows], t[rows]).backward()
    opt.step()
    out["step"] = [p.detach().numpy().copy() for p in model.parameters()]
    opt.clear_grad()
    out["cleared"] = all(p.grad is None for p in model.parameters())
    opt.minimize(mlp_loss(model._layers, x[rows], t[rows]))
    out["minimize"] = [p.detach().numpy().copy()
                       for p in model.parameters()]
    opt.set_lr(lr / 2)
    out["lr"] = (opt.get_lr(), opt._learning_rate,
                 sorted(opt.state_dict()), opt.param_groups[0]["lr"])
    return out
