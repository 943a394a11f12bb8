"""The port's data-parallel layer (`dclip_tpu_torch.parallel`, the global
losses of `ops.losses`, `cli.common.init_multihost`) against the JAX
package's mesh: `make_mesh`'s shapes and errors, `pad_batch_to`, the
partial env triple, and `info_nce_global` / `distillation_loss_global` on
N gloo ranks (tests/torch_dp_worker.py) against JAX's in `shard_map` over
N CPU devices: values, and each rank's gradient against JAX's gradient of
that rank's shard."""
import numpy as np
import pytest
import torch

import torch_dp

from dclip_tpu.core.config import MeshConfig as JaxMeshConfig
from dclip_tpu_torch.core.config import MeshConfig
from dclip_tpu_torch.parallel import mesh as pmesh

B, D = 8, 16
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _jax_outcome(dp, mp, n):
    import jax

    from dclip_tpu.parallel.mesh import make_mesh

    try:
        m = make_mesh(JaxMeshConfig(data_parallel=dp, model_parallel=mp),
                      devices=jax.devices("cpu")[:n])
        return ("ok", m.shape["data"], m.shape["model"])
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("dp,mp", [(-1, 1), (1, 1), (2, 1), (-1, 2), (3, 2)])
def test_one_process_mesh_matches_jax_rules(dp, mp):
    """Without a process group the port has one rank, as a one-device JAX
    mesh: the same shapes, and JAX's ValueError word for word where the
    mesh needs more devices."""
    want = _jax_outcome(dp, mp, 1)
    if want[0] == "ok":
        m = pmesh.make_mesh(MeshConfig(data_parallel=dp, model_parallel=mp))
        assert (m.shape["data"], m.shape["model"]) == want[1:]
        assert not m.distributed and m.is_primary and m.rows(6) == (0, 6)
    else:
        with pytest.raises(ValueError) as e:
            pmesh.make_mesh(MeshConfig(data_parallel=dp, model_parallel=mp))
        assert str(e.value) == want[1]
    # One process is one slice: the multi-slice mesh is make_mesh's.
    assert pmesh.make_multislice_mesh() == pmesh.make_mesh()


@pytest.mark.parametrize("n", [1, 3, 4, 5])
def test_pad_batch_to_matches_jax(n):
    from dclip_tpu.parallel.mesh import pad_batch_to as jax_pad

    rng = np.random.RandomState(n)
    batch = {"a": rng.rand(n, 3).astype(np.float32), "b": np.arange(n * 2).reshape(n, 2)}
    got, valid = pmesh.pad_batch_to(batch, 4)
    want, want_valid = jax_pad(batch, 4)
    assert valid == want_valid == n
    for k in batch:
        np.testing.assert_array_equal(got[k], want[k])


def test_shard_batch_takes_each_ranks_rows():
    """Rank r of N takes rows [r n / N, (r + 1) n / N) of every field,
    the concatenation over ranks is the batch, and an uneven split raises."""
    batch = {"x": np.arange(12).reshape(6, 2), "y": np.arange(6), "z": None}
    parts = [pmesh.shard_batch(batch, pmesh.Mesh(size=3, rank=r)) for r in range(3)]
    np.testing.assert_array_equal(np.concatenate([p["x"] for p in parts]), batch["x"])
    assert parts[1]["y"].tolist() == [2, 3] and parts[2]["z"] is None
    with pytest.raises(ValueError, match="evenly"):
        pmesh.shard_batch(batch, pmesh.Mesh(size=4, rank=0))


def test_init_multihost_partial_env_triple_is_explicit(monkeypatch):
    """DCLIP_COORDINATOR without the rest of the triple: the JAX CLI's
    SystemExit naming the missing variables (tests/test_multihost.py:103),
    before any process group is made."""
    from dclip_tpu.cli.common import init_multihost as jax_init
    from dclip_tpu_torch.cli.common import init_multihost

    monkeypatch.setenv("DCLIP_COORDINATOR", "127.0.0.1:1234")
    monkeypatch.delenv("DCLIP_NUM_PROCESSES", raising=False)
    monkeypatch.setenv("DCLIP_PROCESS_ID", "0")
    for fn in (jax_init, lambda: init_multihost("cpu")):
        with pytest.raises(SystemExit, match="DCLIP_NUM_PROCESSES") as e:
            fn()
        assert "must be set together" in str(e.value)
    monkeypatch.setenv("DCLIP_NUM_PROCESSES", "2")
    monkeypatch.setenv("DCLIP_PROCESS_ID", "")  # empty counts as unset
    with pytest.raises(SystemExit, match="DCLIP_PROCESS_ID"):
        init_multihost("cpu")
    assert not torch.distributed.is_initialized()


def test_one_rank_collectives_are_the_identity():
    """The one-rank mesh runs no collective: gathers and sums return their
    input, the gradient reduction and the broadcast change nothing."""
    m = pmesh.local_mesh()
    x = torch.randn(3, 4, requires_grad=True)
    assert pmesh.gather_rows(x, m) is x and pmesh.sum_across_ranks(x, m) is x
    assert pmesh.gather_cat(x, m, dim=1) is x
    p = torch.nn.Parameter(torch.ones(2))
    pmesh.all_reduce_grads([p], m)
    pmesh.broadcast_([p], m)
    assert p.grad is None and p.tolist() == [1.0, 1.0]


def _jax_global(arrays, n):
    """JAX's global losses in shard_map over n CPU devices: values and the
    gradients with respect to the global si / st (each rank's shard is its
    rows)."""
    import jax
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    from dclip_tpu.ops.losses import distillation_loss_global, info_nce_global

    mesh = Mesh(np.array(jax.devices("cpu")[:n]), ("data",))

    def run(fn, n_in):
        sm = shard_map(fn, mesh=mesh, in_specs=(P("data"),) * n_in, out_specs=P(),
                       check_vma=False)
        return jax.jit(jax.value_and_grad(sm, argnums=(0, 1)))(
            *(arrays[k] for k in ("si", "st", "ti", "tt")[:n_in]))

    distill = run(lambda a, b, c, d: distillation_loss_global(a, b, c, d, "data", 0.05, 0.7)[0],
                  4)
    nce = run(lambda a, b: info_nce_global(a, b, "data", 0.05), 2)
    parts = jax.jit(shard_map(
        lambda a, b, c, d: distillation_loss_global(a, b, c, d, "data", 0.05, 0.7)[1],
        mesh=mesh, in_specs=(P("data"),) * 4, out_specs=P(), check_vma=False))(
        *(arrays[k] for k in ("si", "st", "ti", "tt")))
    return distill, nce, {k: float(v) for k, v in parts.items()}


@pytest.fixture(scope="module")
def loss_inputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("losses")
    rng = np.random.RandomState(7)
    arrays = {k: rng.standard_normal((B, D)).astype(np.float32) for k in ("si", "st", "ti", "tt")}
    np.savez(tmp / "inputs.npz", **arrays)
    return tmp, arrays


@pytest.mark.parametrize("n", [2, 4])
def test_global_losses_match_jax_shard_map(loss_inputs, n):
    """Values on every rank equal JAX's; rank r's gradient is JAX's
    gradient of rank r's rows (its shard); the ranks' mesh outcomes follow
    JAX's rules over n devices (one process per card: a mesh smaller than
    the group raises; a model axis of 2 takes n / 2 data ranks, the model
    axis the fast one)."""
    tmp, arrays = loss_inputs
    meshes = [(-1, 1), (n, 1), (n + 1, 1), (1, 1), (-1, 2)]
    outs = torch_dp.run_ranks(tmp, f"losses_{n}", {
        "scenario": "losses", "inputs": str(tmp / "inputs.npz"), "meshes": meshes}, n)
    (dv, (dsi, dst)), (nv, (nsi, nst)), parts = _jax_global(arrays, n)
    b = B // n
    for r, out in enumerate(outs):
        for k, v in parts.items():
            np.testing.assert_allclose(out["distill_" + k].item(), v, err_msg=k, **LOSS_TOL)
        np.testing.assert_allclose(out["distill_loss"].item(), float(dv), **LOSS_TOL)
        np.testing.assert_allclose(out["info_nce"].item(), float(nv), **LOSS_TOL)
        rows = slice(r * b, (r + 1) * b)
        for got, want in ((out["distill_dsi"], dsi), (out["distill_dst"], dst),
                          (out["info_nce_dsi"], nsi), (out["info_nce_dst"], nst)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want)[rows], **GRAD_TOL)
        got = out["meshes"]
        assert got[0] == ("ok", n, r, 1, 0) and got[1] == ("ok", n, r, 1, 0)
        assert got[2] == ("ValueError", _jax_outcome(n + 1, 1, n)[1])
        assert got[3][0] == "ValueError" and "every rank" in got[3][1]
        assert got[4] == ("ok", n // 2, r // 2, 2, r % 2)
