"""The port's tensor-parallel layers and ops
(paddle_tpu_torch.distributed.fleet.layers.mpu) over 2 gloo ranks on the
CPU: each rank holds its shard of the same numpy weights, and the layers'
outputs and gradients (input, weight shard, bias) equal the unsharded
torch computation and the JAX package's ``mp_layers`` on the whole
weights. Also the ops' forward/backward pairs and the model-parallel RNG
tracker."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle  # noqa: F401  (CPU/virtual-device conftest setup)
from paddle_tpu.distributed.fleet.layers.mpu import mp_layers as jml
from torch_dist_workers import mpu_worker, shard_first, shard_last
from torch_dist_workers import spawn_ranks
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

W = 2
TOL = dict(rtol=1e-5, atol=1e-5)


def _data():
    rng = np.random.default_rng(0)

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return {
        "column": dict(x=f(3, 8), w=f(8, 6), b=f(6), g=f(3, 6)),
        "row": dict(x=f(3, 8), w=f(8, 6), b=f(6), g=f(3, 6)),
        "embed": dict(w=f(10, 4), ids=np.array([[1, 7, 9], [0, 5, 3]]),
                      g=f(2, 3, 4)),
        "ce": dict(logits=f(5, 10), label=np.array([[1], [9], [4], [-100],
                                                    [5]]),
                   ignore=-100, g=f(5)),
    }


DATA = _data()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn_ranks(mpu_worker, W, tmp_path_factory.mktemp("mpu"), DATA)


def _torch_linear(d):
    x = torch.as_tensor(d["x"]).requires_grad_()
    w = torch.as_tensor(d["w"]).requires_grad_()
    b = torch.as_tensor(d["b"]).requires_grad_()
    y = x @ w + b
    (y * torch.as_tensor(d["g"])).sum().backward()
    return dict(y=y.detach().numpy(), gx=x.grad.numpy(), gw=w.grad.numpy(),
                gb=b.grad.numpy())


def _jax_layer(kind, d):
    layer = {"column": jml.ColumnParallelLinear,
             "row": jml.RowParallelLinear}[kind](*d["w"].shape)
    layer.weight.set_value(d["w"])
    layer.bias.set_value(d["b"])
    x = paddle.to_tensor(d["x"], stop_gradient=False)
    y = layer(x)
    (y * paddle.to_tensor(d["g"])).sum().backward()
    return dict(y=y.numpy(), gx=x.grad.numpy(), gw=layer.weight.grad.numpy(),
                gb=layer.bias.grad.numpy())


def _close(got, want):
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("gather", [True, False])
def test_column_parallel_linear(ranks, gather):
    d = DATA["column"]
    want = _torch_linear(d)
    ref = _jax_layer("column", d)
    for k in want:
        _close(ref[k], want[k])
    for r, res in enumerate(ranks):
        got = res[f"column_{gather}"]
        y = want["y"] if gather else shard_last(want["y"], W, r)
        _close(got["y"], y)
        _close(got["gx"], want["gx"])
        _close(got["gw"], shard_last(want["gw"], W, r))
        _close(got["gb"], shard_last(want["gb"], W, r))


@pytest.mark.parametrize("parallel", [False, True])
def test_row_parallel_linear(ranks, parallel):
    d = DATA["row"]
    want = _torch_linear(d)
    ref = _jax_layer("row", d)
    for k in want:
        _close(ref[k], want[k])
    for r, res in enumerate(ranks):
        got = res[f"row_{parallel}"]
        _close(got["y"], want["y"])
        gx = shard_last(want["gx"], W, r) if parallel else want["gx"]
        _close(got["gx"], gx)
        _close(got["gw"], shard_first(want["gw"], W, r))
        _close(got["gb"], want["gb"])


def test_vocab_parallel_embedding(ranks):
    d = DATA["embed"]
    w = torch.as_tensor(d["w"]).requires_grad_()
    y = w[torch.as_tensor(d["ids"])]
    (y * torch.as_tensor(d["g"])).sum().backward()
    layer = jml.VocabParallelEmbedding(*d["w"].shape)
    layer.weight.set_value(d["w"])
    ref = layer(paddle.to_tensor(d["ids"]))
    np.testing.assert_array_equal(ref.numpy(), y.detach().numpy())
    for r, res in enumerate(ranks):
        # the masked lookup plus the all-reduce adds zeros: exact
        np.testing.assert_array_equal(res["embed"]["y"], y.detach().numpy())
        _close(res["embed"]["gw"], shard_first(w.grad.numpy(), W, r))


def test_parallel_cross_entropy(ranks):
    d = DATA["ce"]
    x = torch.as_tensor(d["logits"]).requires_grad_()
    loss = torch.nn.functional.cross_entropy(
        x, torch.as_tensor(d["label"][:, 0]), reduction="none",
        ignore_index=d["ignore"])
    (loss * torch.as_tensor(d["g"])).sum().backward()
    ref = jml.ParallelCrossEntropy(ignore_index=d["ignore"])(
        paddle.to_tensor(d["logits"]), paddle.to_tensor(d["label"]))
    _close(ref.numpy(), loss.detach().numpy())
    for r, res in enumerate(ranks):
        _close(res["ce"]["y"], loss.detach().numpy())
        _close(res["ce"]["gx"], shard_last(x.grad.numpy(), W, r))


def test_ops_forward_backward_pairs(ranks):
    """_c_split then _c_concat is the identity and its backward splits the
    gradient back; _c_identity's backward all-reduces; _mp_allreduce sums."""
    for r, res in enumerate(ranks):
        y, gx = res["split_concat"]
        x = np.arange(8, dtype=np.float32).reshape(2, 4)
        want = np.concatenate([shard_last(x + q, W, q) for q in range(W)], -1)
        np.testing.assert_array_equal(y, want)
        # concat's backward takes this rank's slice, split's gathers it
        np.testing.assert_array_equal(
            gx, np.concatenate([np.full((2, 2), float(q + 1))
                                for q in range(W)], -1))
        gid, red = res["identity_allreduce"]
        np.testing.assert_array_equal(gid, np.full(2, 3.0))
        np.testing.assert_array_equal(red, np.full(2, 3.0))


def test_model_parallel_rng(ranks):
    """One global seed (equal draws outside the tracker), a distinct
    stream a rank inside it, and the tracker's state advances across
    entries while the default stream resumes where it left."""
    out = [res["rng"] for res in ranks]
    np.testing.assert_array_equal(out[0][0], out[1][0])
    assert not np.array_equal(out[0][1], out[1][1])
    assert not np.array_equal(out[0][1], out[0][2])
    torch.manual_seed(1234)
    a = torch.rand(3).numpy()
    b = torch.rand(3).numpy()
    np.testing.assert_array_equal(out[0][0], a)
    np.testing.assert_array_equal(out[0][3], b)
    g = torch.Generator().manual_seed(1234 + 1024 + 1)
    np.testing.assert_array_equal(out[1][1], torch.rand(3, generator=g))
