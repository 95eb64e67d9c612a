"""The port's process bootstrap, store and eager collectives
(paddle_tpu_torch.distributed: env, store, collective, communication)
over 2 and 4 gloo ranks on the CPU, held against numpy: every op, each
ReduceOp, subgroups and the ``stream`` variants. A world of one (no
process group) is held against the JAX package's single-process
collectives; ``init_parallel_env`` and ``TCPStore`` are checked with their
retry counters, and ``spawn`` starts real ranks."""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as paddle  # noqa: F401  (CPU/virtual-device conftest setup)
from paddle_tpu.distributed import collective as jc
from paddle_tpu_torch import distributed as pd
from paddle_tpu_torch.distributed.store import TCPStore
from torch_dist_workers import collective_worker, rank_input, spawn_ranks
from torch_dist_workers import spawn_target
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def world(request, tmp_path_factory):
    n = request.param
    return n, spawn_ranks(collective_worker, n,
                          tmp_path_factory.mktemp(f"coll{n}"))


def _inputs(n):
    return np.stack([rank_input(r).numpy() for r in range(n)])


REDUCE = {"SUM": np.sum, "MAX": np.max, "MIN": np.min, "PROD": np.prod,
          "AVG": np.mean}


@pytest.mark.parametrize("op", list(REDUCE))
def test_all_reduce_each_op(world, op):
    n, res = world
    want = REDUCE[op](_inputs(n), axis=0)
    for r in res:
        np.testing.assert_allclose(r["all_reduce_" + op], want, rtol=1e-6)


def _expected(name, n, rank):
    x = _inputs(n)
    if name == "all_gather":
        return list(x)
    if name == "all_gather_object":
        return [{"rank": r} for r in range(n)]
    if name == "broadcast":
        return x[n - 1]
    if name == "reduce":
        return x.sum(0)
    if name == "scatter":
        return np.full(2, 10.0 * rank)
    if name == "reduce_scatter":
        return np.full(2, float(sum((r + 1) * (rank + 1) for r in range(n))))
    if name == "all_to_all":
        return [np.full((rank + 1, 2), 100.0 * j + rank) for j in range(n)]
    if name == "alltoall":
        return [np.full(1, 10.0 * j + rank) for j in range(n)]
    if name == "alltoall_single":
        return np.concatenate([np.arange(2 * n)[2 * rank:2 * rank + 2]
                               + 10 * j for j in range(n)])
    if name == "send_recv":
        return np.full(3, float((rank - 1) % n))
    if name == "isend_irecv":
        return np.full(3, (rank - 1) % n + 0.5)
    if name == "gather":
        return list(x) if rank == 0 else []
    if name == "broadcast_object_list":
        return ["from1", 1]
    if name == "scatter_object_list":
        return [f"to{rank}"]
    raise KeyError(name)


OPS = ["all_gather", "all_gather_object", "broadcast", "reduce", "scatter",
       "reduce_scatter", "all_to_all", "alltoall", "alltoall_single",
       "send_recv", "isend_irecv", "gather", "broadcast_object_list",
       "scatter_object_list"]


def _assert_same(got, want):
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(np.asarray(got), want)
    else:
        assert got == want


@pytest.mark.parametrize("name", OPS)
def test_collective_ops(world, name):
    n, res = world
    for rank, r in enumerate(res):
        _assert_same(r[name], _expected(name, n, rank))


def test_gather_and_reduce_scatter_along_a_dim(world):
    """all_gather_dim concatenates every rank's tensor along the dim in
    rank order; reduce_scatter_dim leaves each rank its block of the sum
    (rank-scaled inputs: the sum is the input times n(n+1)/2), f32 and
    bf16 (its sums of small integers exact)."""
    n, res = world
    ins = [rank_input(r).numpy() for r in range(n)]
    big = np.arange(4 * n * 3, dtype=np.float32).reshape(4 * n, 3)
    total = big * (n * (n + 1) // 2)
    for r, out in enumerate(res):
        np.testing.assert_array_equal(out["all_gather_dim"][0],
                                      np.concatenate(ins, 0))
        np.testing.assert_array_equal(out["all_gather_dim"][1],
                                      np.concatenate(ins, 1))
        mine = total[4 * r:4 * r + 4]
        f32, cols, bf16 = out["reduce_scatter_dim"]
        np.testing.assert_array_equal(f32, mine)
        np.testing.assert_array_equal(cols, mine.T)
        np.testing.assert_array_equal(bf16, mine)


def test_env_and_backend(world):
    n, res = world
    for rank, r in enumerate(res):
        assert r["env"] == (rank, n, True, n, "gloo", n)


def test_subgroups(world):
    """Groups made on every rank in the same order; members reduce,
    gather and broadcast among themselves, the others pass through."""
    n, res = world
    x = _inputs(n)
    groups = [[0, 1]] + ([[1, 3]] if n == 4 else [])
    for rank, r in enumerate(res):
        for members, (ranks, grank, member, red, gath, bc) in zip(
                groups, r["subgroups"]):
            assert ranks == members
            assert member == (rank in members)
            if rank in members:
                assert grank == members.index(rank)
                np.testing.assert_array_equal(red, x[members].sum(0))
                assert [float(g[0]) for g in gath] == [float(m)
                                                       for m in members]
                assert float(bc[0]) == members[-1]
            else:
                assert grank == -1
                np.testing.assert_array_equal(red, x[rank])
                assert float(bc[0]) == rank


def test_stream_variants(world):
    n, res = world
    x = _inputs(n)
    for rank, r in enumerate(res):
        st = r["stream"]
        np.testing.assert_array_equal(st["all_reduce"], x.max(0))
        _assert_same(st["all_gather"], list(x))
        np.testing.assert_array_equal(st["broadcast"], x[0])
        np.testing.assert_array_equal(st["reduce"], x.min(0))
        np.testing.assert_array_equal(
            st["reduce_scatter"],
            np.full(2, float(sum(q + rank for q in range(n)))))
        np.testing.assert_array_equal(st["scatter"], np.full(2, 7.0 * rank))
        _assert_same(st["alltoall_single"],
                     _expected("alltoall_single", n, rank))
        _assert_same(st["alltoall"], _expected("alltoall", n, rank))
        _assert_same(st["gather"], list(x) if rank == 1 else [])
        want = np.full(2, 5.0) if rank == 1 else np.zeros(2)
        np.testing.assert_array_equal(st["send_recv"], want)


def test_store_across_ranks(world):
    n, res = world
    for rank, r in enumerate(res):
        assert r["store_gather"] == [f"v{q}".encode() for q in range(n)]
        assert r["store_total"] == sum(range(1, n + 1))


# ---------------------------------------------------------------------------
# a world of one: the reference's single-process results
# ---------------------------------------------------------------------------
def _j(a):
    return paddle.to_tensor(np.asarray(a, np.float32))


SINGLE = ["all_reduce", "all_gather", "broadcast", "reduce", "scatter",
          "reduce_scatter", "all_to_all", "alltoall_single", "send_recv",
          "gather", "all_gather_object", "barrier"]


@pytest.mark.parametrize("name", SINGLE)
def test_world_of_one_equals_reference(name):
    """No process group: each op is what the reference's is in one
    process (the identity, a copy into the list, the list's first or
    summed element, the p2p buffer)."""
    x = rank_input(3)
    xs = [rank_input(1), rank_input(2)]
    jx = _j(x.numpy())
    jxs = [_j(t.numpy()) for t in xs]
    if name in ("all_reduce", "broadcast", "reduce"):
        got = getattr(pd, name)(x.clone())
        want = getattr(jc, name)(jx)
    elif name in ("all_gather", "gather"):
        got, want = [], []
        getattr(pd, name)(got, x) if name == "all_gather" \
            else pd.gather(x, got)
        getattr(jc, name)(want, jx) if name == "all_gather" \
            else jc.gather(jx, want)
    elif name == "scatter":
        got = pd.scatter(torch.zeros(2, 3), xs)
        want = jc.scatter(_j(np.zeros((2, 3))), jxs)
    elif name == "reduce_scatter":
        got = pd.reduce_scatter(torch.zeros(2, 3), xs)
        want = jc.reduce_scatter(_j(np.zeros((2, 3))), jxs)
        one = pd.reduce_scatter(torch.zeros(2, 3), xs[:1])
        np.testing.assert_array_equal(
            one.numpy(), jc.reduce_scatter(_j(np.zeros((2, 3))),
                                           jxs[:1]).numpy())
    elif name == "all_to_all":
        got, want = [], []
        pd.all_to_all(got, xs)
        jc.all_to_all(want, jxs)
    elif name == "alltoall_single":
        got = pd.alltoall_single(torch.zeros(2, 3), x)
        want = jc.alltoall_single(_j(np.zeros((2, 3))), jx)
    elif name == "send_recv":
        pd.send(x)
        jc.send(jx)
        got = pd.recv(torch.zeros(2, 3))
        want = jc.recv(_j(np.zeros((2, 3))))
    elif name == "all_gather_object":
        got, want = [], []
        pd.all_gather_object(got, {"a": 1})
        jc.all_gather_object(want, {"a": 1})
        assert got == want
        return
    else:
        pd.barrier()
        jc.barrier()
        assert pd.get_world_size() == 1 and pd.get_rank() == 0
        return
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w.numpy())
    else:
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_reduce_op_and_group_surface_equal_reference():
    for name in ("SUM", "MAX", "MIN", "PROD", "AVG"):
        assert getattr(pd.ReduceOp, name) == getattr(jc.ReduceOp, name)
    g, jg = pd.new_group([0]), jc.new_group([0])
    assert (g.ranks, g.nranks, g.rank, g.is_member()) \
        == (jg.ranks, jg.nranks, jg.rank, jg.is_member())
    assert pd.get_group().ranks == jc.get_group().ranks == [0]


# ---------------------------------------------------------------------------
# bootstrap: init_parallel_env, TCPStore, spawn
# ---------------------------------------------------------------------------
def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def obs_on():
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.distributed.resilience import retry  # noqa: F401
    from paddle_tpu_torch.framework.flags import get_flag, set_flags

    obs.get_registry().reset()
    obs.enable()
    retries = get_flag("ft_bootstrap_retries")
    set_flags({"ft_bootstrap_retries": 1, "ft_bootstrap_backoff": 0.01})
    try:
        yield obs.get_registry()
    finally:
        set_flags({"ft_bootstrap_retries": retries,
                   "ft_bootstrap_backoff": 0.1})
        obs.disable()
        obs.get_registry().reset()


def test_init_parallel_env_retries_counted(obs_on, monkeypatch):
    """A rank whose master never comes up retries with backoff (counted
    in dist_init_retries_total) and then raises; the backend is the one
    asked for."""
    from paddle_tpu_torch.distributed import env

    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
    monkeypatch.setenv("PADDLE_MASTER", f"127.0.0.1:{_free_port()}")
    monkeypatch.setenv("PADDLE_DISTRI_BACKEND", "gloo")
    assert env.default_backend() == "gloo"
    with pytest.raises(Exception):
        env.init_parallel_env(timeout=1)
    assert not env.is_initialized()
    assert obs_on.counter("dist_init_retries_total").labels().value == 1
    monkeypatch.delenv("PADDLE_DISTRI_BACKEND")
    assert env.default_backend() == ("nccl" if torch.cuda.is_available()
                                     else "gloo")


def test_tcp_store_ops_and_connect_retries(obs_on):
    master = TCPStore("127.0.0.1", 0, is_master=True, world_size=1)
    client = TCPStore("127.0.0.1", master.port, world_size=1, timeout=5)
    client.set("k", "v")
    assert client.get("k") == b"v" and master.wait("k") == b"v"
    assert client.get("missing") is None
    assert client.add("n", 2) == 2 and master.add("n", 3) == 5
    assert client.gather("p", 0, 1, b"x") == [b"x"]
    client.barrier("b", 1)
    assert obs_on.counter("dist_store_connect_retries_total").labels().value == 0
    dead = _free_port()
    with pytest.raises(ConnectionError):
        TCPStore("127.0.0.1", dead, world_size=1, timeout=2)
    assert obs_on.counter("dist_store_connect_retries_total").labels().value == 1
    with pytest.raises(NotImplementedError, match="every interface"):
        TCPStore("127.0.0.1", 0, is_master=True, bind_addr="127.0.0.1")
    client.close()
    master.close()


def test_spawn_starts_ranks(tmp_path):
    """spawn(nprocs=2) starts two ranks that find the env contract and
    meet in an all-reduce over the backend asked for."""
    pd.spawn(spawn_target, args=(str(tmp_path),), nprocs=2, backend="gloo")
    seen = [json.loads((tmp_path / f"spawned{r}.json").read_text())
            for r in range(2)]
    assert [s["rank"] for s in seen] == [0, 1]
    assert all(s["world"] == 2 and s["backend"] == "gloo" and s["sum"] == 3.0
               for s in seen)
    assert seen[0]["master"] == seen[1]["master"]


def test_spawn_fails_with_a_failing_rank(tmp_path):
    with pytest.raises(Exception, match="fails on purpose"):
        pd.spawn(spawn_target, args=(str(tmp_path), 1), nprocs=2,
                 backend="gloo")


def test_checkpoint_still_refuses():
    with pytest.raises(NotImplementedError, match="A10.6"):
        pd.checkpoint
