"""The port's parallel package against petr_tpu's, on Gloo CPU ranks.

The port's ranks are processes (``parallel.distributed.spawn``), each on
its plain kernel versions; petr_tpu runs on conftest's 8-device CPU mesh as
its own tests do (`tests/test_sharded_attention.py`), its flash kernel in
interpret mode. The same numpy inputs go to both.

* ``sharded_cross_attention`` and ``sharded_flash_cross_attention`` at 2
  and 4 ranks against dense attention and against petr_tpu's on a (4, 2)
  and a (2, 4) mesh: outputs within atol 1e-5 (fp32), gradients of q, k
  and v within rtol 1e-4 (plus 1e-4 of the largest entry, for entries near
  0) against dense attention in every case and against petr_tpu's flash at
  its test's shapes; a shard that is all padding, whose keys can hold
  anything; a key count the ranks do not divide (the last shard padded
  and masked); dropout 0.1 against the unsharded port attention, which
  needs the hash's key offset; every rank holds the same result.
* The hash offsets: a shard's keep mask is the slice of the whole mask bit
  for bit, and equals petr_tpu's ``_dropout_keep`` at the global
  coordinates.
* Token-sharded decoders on the plain attention branch, PETR's layers
  and Depthr's, at dropout 0 and 0.1, on 2 ranks against the one-process
  decoder with the same weights and seeds: the output within atol 1e-5,
  the inputs' and every parameter's gradient within rtol 1e-4 of its
  largest entry (or 1e-3 of the model's largest, for gradients near 0).
  The ranks must draw the global dropout mask and keep their key slice.
* ``make_mesh`` / ``make_pod_mesh`` factorisations, ``shard_batch`` rows,
  the single-process no-ops, and the card as the dryrun's default.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh

from petr_tpu.ops.pallas.cross_attention import _dropout_keep as jax_dropout_keep
from petr_tpu.parallel.sharded_attention import sharded_cross_attention as jax_sharded
from petr_tpu.parallel.sharded_attention import sharded_flash_cross_attention as jax_sharded_flash
from petr_tpu_torch.ops import cross_attention as ca
from petr_tpu_torch.parallel import Mesh, current_mesh, make_mesh, shard_batch, use_mesh
from petr_tpu_torch.parallel.distributed import init_distributed, make_pod_mesh, spawn
from petr_tpu_torch.parallel.dryrun import dryrun_multichip
from petr_tpu_torch.parallel.dryrun import main as dryrun_main
from tests.test_torch_port_parallel_workers import (attention_case, attention_inputs, build_decoder, decoder_case,
                                                    decoder_inputs, decoder_run)

OUT_ATOL = 1e-5
GRAD_RTOL = 1e-4
RATE, SEED = 0.1, -77

# name -> (B, H, Q, D, L, mask, pad_from at 2 ranks, at 4 ranks, dropout), the shapes of
# tests/test_sharded_attention.py; pad_from puts a whole shard in the padding
CASES = {
    "plain_shapes": (2, 4, 30, 16, 64, "random", None, None, 0.0),
    "flash_shapes": (1, 2, 64, 32, 1024, "random", None, None, 0.0),
    "empty_shard": (1, 1, 32, 32, 1024, "tail", 512, 768, 0.0),
    "uneven_keys": (2, 2, 24, 16, 70, "tail", 35, 54, 0.0),
    "dropout": (1, 2, 64, 32, 512, "random", None, None, RATE),
    "empty_shard_garbage": (1, 1, 32, 32, 1024, "tail", 512, 768, 0.0),  # its padded keys at 1e6
}
JAX_CASES = ("plain_shapes", "flash_shapes", "empty_shard")  # petr_tpu needs L divisible by the ranks
JAX_GRADS = ("flash_shapes",)  # its gradients too (an interpret-mode VJP compile each)
ROUTES = [(name, route) for name in CASES for route in ("plain", "flash") if route == "flash" or not CASES[name][-1]]


def _inputs(name, world):
    B, H, Q, D, L, mask, pad2, pad4, _ = CASES[name]
    pad = pad2 if world == 2 else pad4
    inp = attention_inputs(B, H, Q, D, L, seed=len(name.replace("_garbage", "")), mask=mask, pad_from=pad)
    if name.endswith("_garbage"):
        inp["k"][:, :, pad:] = 1e6
    return inp


@pytest.fixture(scope="module", params=[2, 4], ids=lambda w: f"{w}ranks")
def ranks(request):
    world = request.param
    cases = [(_inputs(name, world), CASES[name][-1], SEED) for name in CASES]
    results = spawn(attention_case, world, "gloo", "cpu", args=(cases,))
    return world, results


def _dense(inp, rate=0.0):
    """The unsharded port attention (its plain route) -> out, dq, dk, dv."""
    q, k, v = (torch.from_numpy(inp[n]).requires_grad_(True) for n in "qkv")
    mask = None if inp["mask"] is None else torch.from_numpy(inp["mask"])
    out, _ = ca.flash_cross_attention_plain(q, k, v, mask, rate, SEED if rate else None)
    (out * torch.from_numpy(inp["t"])).sum().backward()
    return {"out": out.detach().numpy(), "dq": q.grad.numpy(), "dk": k.grad.numpy(), "dv": v.grad.numpy()}


def _jax_mesh(world):
    # the model axis of ``world`` devices, as tests/test_sharded_attention.py's (2, 4)
    return JMesh(np.asarray(jax.devices()[:8]).reshape(8 // world, world), ("data", "model"))


def _jax(name, inp, world, flash):
    q, k, v, t = (jnp.asarray(inp[n]) for n in "qkvt")
    mask = None if inp["mask"] is None else jnp.asarray(inp["mask"])
    fn = jax_sharded_flash if flash else jax_sharded
    out = fn(q, k, v, mask, _jax_mesh(world))
    if not flash or name not in JAX_GRADS:  # petr_tpu's plain form takes pmax, which has no derivative
        return {"out": np.asarray(out)}
    grads = jax.grad(lambda q, k, v: (fn(q, k, v, mask, _jax_mesh(world)) * t).sum(), argnums=(0, 1, 2))(q, k, v)
    return {"out": np.asarray(out), **{f"d{n}": np.asarray(g) for n, g in zip("qkv", grads)}}


def _close(got, want, what):
    for key, w in want.items():
        if key == "out":
            np.testing.assert_allclose(got[key], w, rtol=0, atol=OUT_ATOL, err_msg=f"{what} out")
        else:
            np.testing.assert_allclose(got[key], w, rtol=GRAD_RTOL, atol=GRAD_RTOL * np.abs(w).max(),
                                       err_msg=f"{what} {key}")


@pytest.mark.parametrize("name, route", ROUTES)  # the plain sharded form has no dropout (as petr_tpu's)
def test_sharded_attention_matches_dense(ranks, name, route):
    world, results = ranks
    i = list(CASES).index(name)
    inp = _inputs(name, world)
    want = _dense(inp, CASES[name][-1])
    for rank, res in enumerate(results):  # every rank holds the replicated output and gradients
        _close(res["attention"][i][route], want, f"{name} {route} rank {rank}/{world}")


@pytest.mark.parametrize("route", ["plain", "flash"])
@pytest.mark.parametrize("name", JAX_CASES)
def test_sharded_attention_matches_petr_tpu(ranks, name, route):
    world, results = ranks
    i = list(CASES).index(name)
    inp = _inputs(name, world)
    want = _jax(name, inp, world, flash=route == "flash")
    _close(results[0]["attention"][i][route], want, f"{name} {route} against petr_tpu, {world} ranks")


def test_empty_shard_weighs_nothing(ranks):
    """The last shard is all padding: its keys can hold anything."""
    world, results = ranks
    B, H, Q, D, L, _, pad2, pad4, _ = CASES["empty_shard"]
    assert L - (pad2 if world == 2 else pad4) == L // world  # exactly the last shard
    i, j = list(CASES).index("empty_shard"), list(CASES).index("empty_shard_garbage")
    for route in ("plain", "flash"):
        np.testing.assert_allclose(results[0]["attention"][j][route]["out"], results[0]["attention"][i][route]["out"],
                                   rtol=0, atol=OUT_ATOL)


def test_mesh_factorisations_and_rows(ranks):
    world, results = ranks
    for rank, res in enumerate(results):
        m = res["mesh"]
        assert m["default"]["shape"] == (world, 1) and m["pod"]["shape"] == (world, 1)
        assert m["data1"]["shape"] == (1, world) and m["data1"]["rows"] == list(range(2 * world))
        assert m["default"]["rows"] == [2 * rank, 2 * rank + 1]
        assert m["data1"]["index"] == (0, rank)
        size = -(-10 // world)
        assert m["data1"]["token_range"] == (min(rank * size, 10), min(rank * size + size, 10), size)
        assert m["model2"]["shape"] == m["pod2"]["shape"] == (world // 2, 2)
        d, mi = divmod(rank, 2)  # ranks row by row: rank = data_index * model + model_index
        assert m["model2"]["index"] == (d, mi)
        local = 2 * world // (world // 2)
        assert m["model2"]["rows"] == list(range(d * local, (d + 1) * local))


def test_spawn_fails_with_the_rank_that_raised():
    with pytest.raises(Exception, match="not subscriptable"):
        spawn(attention_case, 2, "gloo", "cpu", args=([(None, 0.0, None)],))


def test_the_card_is_the_dryruns_default():
    """``dryrun_multichip`` and its CLI run their ranks on the card unless
    the CPU is asked for, and raise before spawning when there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="cuda"):
        dryrun_main(["2"])
    with pytest.raises(RuntimeError, match="cuda"):
        spawn(attention_case, 2, "gloo", "cuda", args=([],))


@pytest.mark.parametrize("offsets", [(0, 0), (1, 0), (0, 300), (2, 600)])
def test_shard_keep_mask_is_the_slice_of_the_whole(offsets):
    B, H, Q, L, seed = 4, 3, 70, 1024, -123456
    b0, k0 = offsets
    Bs, Ls = 2, 300
    whole = ca.dropout_keep_mask(seed, B, H, Q, L, RATE)
    part = ca.dropout_keep_mask(seed, Bs, H, Q, Ls, RATE, offsets=offsets)
    assert torch.equal(part, whole[b0:b0 + Bs, :, :, k0:k0 + Ls])
    # petr_tpu's hash at the global coordinates: batch*head (b0 + b) * H + h, key block k0 / Ls
    for b in range(Bs):
        for h in range(H):
            want = jax_dropout_keep(jnp.int32(seed), (b0 + b) * H + h, 0, k0 // Ls, Q, Ls, RATE)
            np.testing.assert_array_equal(part[b, h].numpy(), np.asarray(want))


def test_offsets_reach_the_plain_routes():
    """The plain forward and backward with the offsets equal the same shard
    of an unsharded problem's mask: a batch row and a key range."""
    rng = np.random.RandomState(3)
    B, H, Q, L, D = 2, 2, 12, 40, 16
    q, k, v, g = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                  for s in ((B, H, Q, D), (B, H, L, D), (B, H, L, D), (B, H, Q, D)))
    keep = ca.dropout_keep_mask(SEED, B, H, Q, L, RATE)
    b0, k0, Ls = 1, 24, 16
    part = ca.dropout_keep_mask(SEED, 1, H, Q, Ls, RATE, offsets=(b0, k0))
    assert torch.equal(part, keep[b0:b0 + 1, :, :, k0:k0 + Ls])
    qs, ks, vs = (t[b0:b0 + 1].clone().requires_grad_(True) for t in (q, k[:, :, k0:k0 + Ls], v[:, :, k0:k0 + Ls]))
    out, lse = ca.flash_cross_attention_plain(qs, ks, vs, None, RATE, SEED, dropout_offsets=(b0, k0))
    # the same drop by hand: the whole problem's mask, sliced
    s = torch.matmul(qs.detach(), ks.detach().transpose(-1, -2)) / np.sqrt(D)
    p = torch.softmax(s, -1)
    want = torch.matmul(torch.where(part, p / (1 - RATE), 0.0), vs.detach())
    np.testing.assert_allclose(out.detach().numpy(), want.numpy(), atol=1e-5)
    (out * g[b0:b0 + 1]).sum().backward()
    assert torch.isfinite(qs.grad).all() and qs.grad.abs().sum() > 0


def test_single_process_is_a_no_op(monkeypatch):
    for var in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "WORLD_SIZE", "PROCESS_ID", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert init_distributed() is False  # no coordinator, one process: nothing to join
    with pytest.raises(ValueError, match="coordinator"):
        init_distributed(num_processes=2)
    with pytest.raises(ValueError, match="backend"):
        init_distributed("localhost:1", 1, 0, backend="mpi")
    mesh = make_mesh()
    assert mesh.shape == (1, 1) and make_pod_mesh().shape == (1, 1)
    batch = {"images": np.zeros((3, 2)), "n": 4}
    assert shard_batch(batch, mesh)["images"].shape == (3, 2) and shard_batch(batch, mesh)["n"] == 4
    assert current_mesh() is None
    with use_mesh(mesh):
        assert current_mesh() is None  # a one-rank mesh shards nothing
    with use_mesh(Mesh(2, 1, rank=1)):
        assert current_mesh().batch_rows(3) == (6, 3)
    assert current_mesh() is None


DECODER_CASES = [(kind, rate) for kind in ("petr", "depthr") for rate in (0.0, RATE)]


@pytest.fixture(scope="module")
def decoders():
    torch.manual_seed(0)
    weights = {kind: {k: v.numpy().copy() for k, v in build_decoder(kind, 0.0).state_dict().items()}
               for kind in ("petr", "depthr")}
    cases = [(kind, rate, weights[kind], decoder_inputs(kind, seed=i)) for i, (kind, rate) in enumerate(DECODER_CASES)]
    torch.set_num_threads(2)
    sharded = spawn(decoder_case, 2, "gloo", "cpu", args=(cases,))
    return cases, sharded


@pytest.mark.parametrize("i", range(len(DECODER_CASES)), ids=[f"{k}_rate{r}" for k, r in DECODER_CASES])
def test_token_sharded_plain_decoders_match_one_process(decoders, i):
    cases, sharded = decoders
    want = decoder_run(*cases[i])
    top = max(np.abs(g).max() for g in want["grads"].values())
    for rank, res in enumerate(sharded):
        got = res[i]
        what = f"{'/'.join(map(str, DECODER_CASES[i]))} rank {rank}"
        np.testing.assert_allclose(got["out"], want["out"], rtol=0, atol=OUT_ATOL, err_msg=what)
        for k, w in want.items():
            if k.startswith("d"):
                np.testing.assert_allclose(got[k], w, rtol=0, atol=GRAD_RTOL * np.abs(w).max(), err_msg=f"{what} {k}")
        for n, w in want["grads"].items():
            err = np.abs(got["grads"][n] - w).max()
            assert err <= GRAD_RTOL * max(np.abs(w).max(), 1e-3 * top), f"{what} {n}: {err:.3e}"
