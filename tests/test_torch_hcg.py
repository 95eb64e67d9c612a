"""The port's hybrid topology (paddle_tpu_torch.distributed.fleet):
``CommunicateTopology`` equals the JAX package's for several dims, and
``fleet.init`` over 4 gloo ranks gives each rank the process groups the
reference's topology names, a ``DeviceMesh`` over the same layout, and
collectives that stay inside each group."""
import numpy as np
import pytest

import paddle_tpu  # noqa: F401  (CPU/virtual-device conftest setup)
from paddle_tpu.distributed.fleet.topology import \
    CommunicateTopology as JaxTopology
from paddle_tpu_torch.distributed.fleet import CommunicateTopology
from torch_dist_workers import hcg_worker, spawn_ranks
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

NAMES = ["data", "pipe", "sharding", "sep", "model"]


@pytest.mark.parametrize("dims", [[1, 1, 1, 1, 1], [2, 1, 1, 1, 2],
                                  [2, 2, 1, 1, 2], [1, 2, 3, 1, 2],
                                  [3, 1, 2, 2, 1]])
def test_topology_equals_reference(dims):
    t, j = CommunicateTopology(NAMES, dims), JaxTopology(NAMES, dims)
    assert t.world_size() == j.world_size()
    for rank in range(t.world_size()):
        assert t.get_coord(rank) == j.get_coord(rank)
        coord = dict(zip(NAMES, t.get_coord(rank)))
        assert t.get_rank(**coord) == j.get_rank(**coord) == rank
        assert t.get_rank_from_stage(rank, pipe=0) \
            == j.get_rank_from_stage(rank, pipe=0)
    for name, d in zip(NAMES, dims):
        assert t.get_dim(name) == j.get_dim(name) == d
        assert t.get_comm_list(name) == j.get_comm_list(name)
        for i in range(d):
            assert t.get_axis_list(name, i) == j.get_axis_list(name, i)


# dp2 x mp2 given, and mp2 x pp2 with dp left for fleet.init to fill
STRATEGIES = [{"dp_degree": 2, "mp_degree": 2},
              {"mp_degree": 2, "pp_degree": 2},
              {"mp_degree": 2}]
AXES = {"dp": "data", "pp": "pipe", "sharding": "sharding", "sep": "sep",
        "mp": "model"}


@pytest.fixture(scope="module")
def inits(tmp_path_factory):
    return spawn_ranks(hcg_worker, 4, tmp_path_factory.mktemp("hcg"),
                       STRATEGIES)


def _dims(hc):
    deg = {a: hc.get(f"{a}_degree", 1) for a in AXES}
    known = int(np.prod([d for a, d in deg.items() if a != "dp"]))
    if deg["dp"] == 1 and known < 4:
        deg["dp"] = 4 // known       # the reference's fill rule
    return [deg[a] for a in AXES]


@pytest.mark.parametrize("i", range(len(STRATEGIES)))
def test_fleet_init_groups_equal_reference_topology(inits, i):
    dims = _dims(STRATEGIES[i])
    ref = JaxTopology(NAMES, dims)
    for rank, res in enumerate(inits):
        got = res["inits"][i]
        assert list(got["degrees"]) == dims
        assert tuple(got["ranks"]) == ref.get_coord(rank)
        for axis, name in AXES.items():
            want = next(g for g in ref.get_comm_list(name) if rank in g)
            assert got["groups"][axis] == want, (axis, rank)
            # a rank-sum inside the group counts only its members
            assert got["sums"][axis] == sum(want)
            assert got["mesh"][2][axis] == want
        assert got["mesh"][:2] == (tuple(AXES), tuple(dims))
        assert got["src"] == (got["groups"]["dp"][0],
                              got["groups"]["mp"][0])
        stage, pp = ref.get_coord(rank)[1], dims[1]
        assert got["first_last"] == (stage == 0, stage == pp - 1)
        assert got["worker"] == (rank, 4, rank == 0)
        assert got["util"] == ([6, 4], [3], [0, 1, 2, 3])


def test_unported_fleet_calls_name_their_item(inits):
    """The parameter-server calls still raise naming A10.6; the model and
    optimizer wrappers are ported: by the hybrid group's sizes, pipe
    first (PipelineParallel, which raises naming A10.3), then model
    parallel (TensorParallel around the module), and the optimizer in a
    HybridParallelOptimizer over this rank's group."""
    errs = inits[0]["errors"]
    assert len(errs) == 3
    assert all("A10.6" in e for e in errs)
    for res in inits:
        tp_dp, tp_pp, tp_only = (x["wrapped"] for x in res["inits"])
        for got in (tp_dp, tp_only):
            assert got["model"] == "TensorParallel" and got["inner"]
        assert "A10.3" in tp_pp["model_error"]
        for got in (tp_dp, tp_pp, tp_only):
            assert got["optimizer"] == ("HybridParallelOptimizer", True,
                                        "SGD")
