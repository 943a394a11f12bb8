"""The port's tensor parallelism (`dclip_tpu_torch.parallel.tp`, the
(data, model) mesh of `parallel.mesh`, the sharded layers of `models.clip`
and `kernels.vit_block`) against the JAX package's (`dclip_tpu.parallel.tp`,
`dclip_tpu.parallel.mesh`) at `CLIPConfig.tiny_test()` (4 heads: mp 2 and
4 divide), f32.

- The sharding rules, name by name through the weight bridge, the dim
  transposed (a Flax kernel is [in, out], an `nn.Linear` weight [out, in]).
- Shards concatenate back to the whole tensors bit for bit;
  `head_divisibility_check`'s message is JAX's.
- `make_mesh`'s shapes, grid positions and refusals over 4 gloo ranks
  (tests/torch_dp_worker.py) against JAX's over 4 CPU devices;
  `multislice_grid` against JAX's `make_multislice_mesh` with the same
  injected slice function (JAX tests/test_tp.py:114-150), its refusals
  word for word.
- Over 2 and 4 ranks (mp = 2, mp = 4, dp 2 x mp 2): image and text
  features of the module (per-op and kernel attention) and of the region
  encode's block composition against JAX's single-device apply at atol
  2e-5, and the gradient of sum(features^2) for the gathered fc1 weight
  at JAX's tolerances (tests/test_tp.py:51-95); the replicated parameters'
  gradients bit-equal on every rank.
"""
import dataclasses

import numpy as np
import pytest
import torch

import torch_dp
import torch_parity

from dclip_tpu.core.config import CLIPConfig, MeshConfig as JaxMeshConfig
from dclip_tpu_torch.core.config import MeshConfig
from dclip_tpu_torch.models.weights import state_dict_from_jax
from dclip_tpu_torch.parallel import mesh as pmesh
from dclip_tpu_torch.parallel import tp

B = 8
FEATURE_ATOL = 2e-5
GRAD_TOL = dict(atol=2e-4, rtol=1e-3)
FC1 = "vision_model.encoder.layers.0.mlp.fc1.weight"
MESHES = ((1, 2), (1, 4), (2, 2))  # (data_parallel, model_parallel)


def _jax_axis(spec):
    """A JAX PartitionSpec of a 1-D or 2-D leaf -> the index of its model
    axis, None when replicated."""
    axes = [i for i, a in enumerate(tuple(spec)) if a == "model"]
    return axes[0] if axes else None


def test_param_specs_match_jax():
    """Every leaf of the tiny CLIP: JAX's spec carried through
    `state_dict_from_jax` as a probe (1 + the index along the model axis,
    0 for a replicated leaf) lands on the dim the port's rule names."""
    import jax
    from jax.sharding import PartitionSpec as P

    from dclip_tpu.parallel.tp import clip_param_specs

    cfg = CLIPConfig.tiny_test()
    _, params = torch_parity.jax_clip(cfg)
    specs = clip_param_specs(params)

    def probe(leaf, spec):
        a = np.asarray(leaf)
        axis = _jax_axis(spec)
        if axis is None:
            return np.zeros(a.shape, np.float32)
        shape = [1] * a.ndim
        shape[axis] = a.shape[axis]
        return np.broadcast_to(1.0 + np.arange(a.shape[axis]).reshape(shape),
                               a.shape).astype(np.float32)

    probes = state_dict_from_jax(
        jax.tree_util.tree_map(probe, params, specs, is_leaf=lambda x: isinstance(x, P)), cfg)
    got = tp.clip_param_specs(probes)
    assert set(got) == set(probes)
    sharded = 0
    for name, t in probes.items():
        varying = [d for d in range(t.dim())
                   if t.shape[d] > 1 and not torch.equal(t, t.select(d, 0).unsqueeze(d)
                                                          .expand_as(t))]
        want = None if not t.any() else varying[0]
        assert got[name] == want, name
        sharded += want is not None
    # q, k, v (weight and bias), out_proj, fc1 (weight and bias), fc2: 10 a layer.
    assert sharded == 10 * (cfg.vision.num_layers + cfg.text.num_layers)


@pytest.mark.parametrize("mp", [1, 2, 4])
def test_shards_concatenate_to_the_whole(mp):
    """`shard_clip_params` on each model index, concatenated along each
    tensor's dim, gives the whole tensors back bit for bit; replicated
    tensors come back as they went in; param-shaped moments shard by
    the same names."""
    from dclip_tpu_torch.models.weights import random_state_dict

    cfg = CLIPConfig.tiny_test()
    sd = random_state_dict(cfg, 3)
    shards = [tp.shard_clip_params(sd, pmesh.Mesh(model_size=mp, model_index=m))
              for m in range(mp)]
    for name, whole in sd.items():
        dim = tp.param_spec(name)
        if dim is None:
            assert all(s[name] is whole for s in shards), name
        else:
            assert all(s[name].shape[dim] == whole.shape[dim] // mp for s in shards), name
            assert torch.equal(torch.cat([s[name] for s in shards], dim), whole), name
    moments = {n: t + 1 for n, t in sd.items() if "mlp" in n}
    like = tp.shard_clip_params(moments, pmesh.Mesh(model_size=mp, model_index=mp - 1))
    assert all(torch.equal(like[n], shards[-1][n] + 1) for n in moments)


def test_head_divisibility_message_is_jax(cpu_devices):
    from dclip_tpu.parallel.mesh import make_mesh
    from dclip_tpu.parallel.tp import head_divisibility_check

    mesh = make_mesh(JaxMeshConfig(data_parallel=1, model_parallel=8), devices=cpu_devices)
    with pytest.raises(ValueError) as want:
        head_divisibility_check(12, mesh)
    with pytest.raises(ValueError) as got:
        tp.head_divisibility_check(12, pmesh.Mesh(model_size=8))
    assert str(got.value) == str(want.value)
    tp.head_divisibility_check(12, pmesh.Mesh(model_size=4))
    cfg = CLIPConfig.tiny_test()
    cfg = dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, mlp_dim=66))
    with pytest.raises(ValueError, match="mlp_dim=66 not divisible by model-parallel size 4"):
        tp.clip_divisibility_check(cfg, pmesh.Mesh(model_size=4))


def _jax_grid(devices, mesh):
    pos = {id(d): i for i, d in enumerate(devices)}
    return [[pos[id(d)] for d in row] for row in mesh.devices]


def _jax_mesh_outcome(dp, mp, devices):
    from dclip_tpu.parallel.mesh import make_mesh

    try:
        return "ok", _jax_grid(devices, make_mesh(
            JaxMeshConfig(data_parallel=dp, model_parallel=mp), devices=devices))
    except ValueError as e:
        return "ValueError", str(e)


SLICE_FNS = {"div": lambda k: (lambda r: r // k), "mod": lambda k: (lambda r: r % k)}
MULTISLICE = ((2, 4, "div", -1), (1, 4, "div", -1), (4, 4, "div", -1), (2, 2, "div", -1),
              (2, 2, "mod", -1), (4, 2, "mod", -1), (2, 4, "div", 4))
MULTISLICE_REFUSED = ((3, 4, "div", -1), (2, 4, "div", 8), (1, None, "ragged", -1))


def _slice_fn(k, mode):
    return (lambda r: 0 if r < 3 else 1) if mode == "ragged" else SLICE_FNS[mode](k)


@pytest.mark.parametrize("case", MULTISLICE + MULTISLICE_REFUSED,
                         ids=[f"mp{c[0]}_{c[2]}{c[1]}_dp{c[3]}"
                              for c in MULTISLICE + MULTISLICE_REFUSED])
def test_multislice_grid_matches_jax(cpu_devices, case):
    """`multislice_grid` over ranks 0-7 against JAX's `make_multislice_mesh`
    over 8 CPU devices, the same slice function on the device's position:
    the same grid (slice-major data axis, model partners inside a slice),
    or the same refusal word for word."""
    from dclip_tpu.parallel import make_multislice_mesh

    mp, k, mode, dp = case
    fn = _slice_fn(k, mode)
    pos = {id(d): i for i, d in enumerate(cpu_devices)}
    cfg_j = JaxMeshConfig(model_parallel=mp, data_parallel=dp)
    cfg_p = MeshConfig(model_parallel=mp, data_parallel=dp)
    try:
        want = ("ok", _jax_grid(cpu_devices, make_multislice_mesh(
            cfg_j, devices=cpu_devices, slice_index_fn=lambda d: fn(pos[id(d)]))))
    except ValueError as e:
        want = ("ValueError", str(e))
    try:
        got = ("ok", pmesh.multislice_grid(cfg_p, range(8), fn).tolist())
    except ValueError as e:
        got = ("ValueError", str(e))
    assert got == want
    assert (case in MULTISLICE_REFUSED) == (got[0] == "ValueError")


def test_one_slice_is_make_mesh():
    """One slice: no grid, and `make_multislice_mesh` is `make_mesh` (here
    without a process group, the one-rank mesh)."""
    assert pmesh.multislice_grid(MeshConfig(model_parallel=2), range(4), lambda r: 0) is None
    assert pmesh.make_multislice_mesh(MeshConfig()) == pmesh.make_mesh(MeshConfig())


MESH_CASES = ((-1, 1), (-1, 2), (2, 2), (1, 4), (-1, 4), (4, 1), (1, 2), (3, 1), (-1, 3),
              (2, 4), (4, 2), (3, 2))
RANK_MULTISLICE = ((2, 2, "div"), (2, 2, "mod"), (1, 2, "mod"), (4, 2, "div"), (2, 3, "div"))


def test_make_mesh_over_four_ranks_matches_jax(tmp_path):
    """4 gloo ranks: `make_mesh`'s shape and each rank's (data, model)
    position equal JAX's grid over 4 devices (rank r where device r sits);
    JAX's refusal word for word where it refuses, the port's own rule
    (every rank in the mesh) where JAX would leave devices out.
    `make_multislice_mesh` with injected slices places each rank where
    `multislice_grid` does (a group orders its ranks by rank), and its
    default (one host, one slice) is `make_mesh`."""
    import jax

    devices = jax.devices("cpu")[:4]
    outs = torch_dp.run_ranks(tmp_path, "meshes", {
        "scenario": "meshes", "meshes": [list(c) for c in MESH_CASES],
        "multislice": [list(c) for c in RANK_MULTISLICE]}, 4)
    for r, out in enumerate(outs):
        for (dp, mp), got in zip(MESH_CASES, out["meshes"]):
            kind, want = _jax_mesh_outcome(dp, mp, devices)
            if kind == "ValueError":
                assert got == ("ValueError", want), (dp, mp)
            elif sum(len(row) for row in want) < 4:
                assert got[0] == "ValueError" and "every rank" in got[1], (dp, mp)
            else:
                (i,), (j,) = np.nonzero(np.asarray(want) == r)
                assert got == ("ok", len(want), i, len(want[0]), j), (dp, mp)
        for (mp, k, mode), got in zip(RANK_MULTISLICE, out["multislice"]):
            try:
                grid = pmesh.multislice_grid(MeshConfig(model_parallel=mp), range(4),
                                             SLICE_FNS[mode](k))
            except ValueError as e:
                assert got == ("ValueError", str(e))
                continue
            (i,), (j,) = np.nonzero(grid == r)
            want_d = sorted(grid[:, j].tolist()).index(r)
            want_m = sorted(grid[i, :].tolist()).index(r)
            assert got == ("ok", grid.shape[0], want_d, grid.shape[1], want_m), (mp, k, mode)
        assert out["node_multislice"] == (2, r // 2, 2, r % 2)


@pytest.fixture(scope="module")
def forward_setup(tmp_path_factory):
    """Fan-in weights (attention far from uniform), 8 images and 8
    captions (padded, one without EOS), and JAX's single-device features
    and fc1 gradient of sum(image features^2)."""
    import jax
    import jax.numpy as jnp

    from dclip_tpu.models.clip import CLIPModule as JaxCLIPModule

    tmp = tmp_path_factory.mktemp("tp_forward")
    cfg = CLIPConfig.tiny_test()
    params = torch_parity.jax_clip_fan_in(cfg, seed=1)
    model = JaxCLIPModule(cfg)
    rng = np.random.RandomState(5)
    t, eos = cfg.text.max_length, cfg.text.eos_token_id
    ids = rng.randint(1, eos - 2, size=(B, t)).astype(np.int32)
    mask = np.ones((B, t), np.int32)
    for row, n in enumerate((3, 6, t // 2, 5, 9, 2, 12)):
        ids[row, n - 1] = eos
        ids[row, n:] = 0
        mask[row, n:] = 0
    pixels = torch_parity.pixels(cfg, B, seed=6)
    variables = {"params": params}
    img = model.apply(variables, jnp.asarray(pixels), method=model.get_image_features)
    txt = model.apply(variables, jnp.asarray(ids), jnp.asarray(mask),
                      method=model.get_text_features)

    def loss(p):
        feats = model.apply({"params": p}, jnp.asarray(pixels), method=model.get_image_features)
        return jnp.sum(feats ** 2)

    grads = state_dict_from_jax(jax.device_get(jax.jit(jax.grad(loss))(params)), cfg)
    torch.save(state_dict_from_jax(params, cfg), tmp / "clip.pt")
    np.savez(tmp / "inputs.npz", pixels=pixels, ids=ids, mask=mask)
    return dict(tmp=tmp, img=np.asarray(img), txt=np.asarray(txt), grads=grads)


@pytest.mark.parametrize("dp,mp", MESHES, ids=[f"dp{d}_mp{m}" for d, m in MESHES])
def test_tp_forward_and_gradients_match_jax(forward_setup, dp, mp):
    """dp x mp gloo ranks, each on its data rows and its model slices."""
    s = forward_setup
    outs = torch_dp.run_ranks(s["tmp"], f"fwd_{dp}x{mp}", {
        "scenario": "tp_forward", "clip": str(s["tmp"] / "clip.pt"),
        "inputs": str(s["tmp"] / "inputs.npz"), "mesh": [dp, mp]}, dp * mp)
    per = B // dp
    for r, out in enumerate(outs):
        rows = slice((r // mp) * per, (r // mp + 1) * per)
        assert out["round_trip"]
        assert out["shapes"][FC1] == (64 // mp, 32)
        assert out["shapes"]["vision_model.encoder.layers.0.self_attn.out_proj.weight"] == \
            (32, 32 // mp)
        for key in ("img_False", "img_True", "img_blocks", "img_blocks_whole"):
            np.testing.assert_allclose(out[key].numpy(), s["img"][rows], atol=FEATURE_ATOL,
                                       rtol=0, err_msg=key)
        for key in ("txt_False", "txt_True"):
            np.testing.assert_allclose(out[key].numpy(), s["txt"][rows], atol=FEATURE_ATOL,
                                       rtol=0, err_msg=key)
        np.testing.assert_allclose(out["grads"][FC1].numpy(), s["grads"][FC1].numpy(),
                                   **GRAD_TOL)
    for name, g in outs[0]["shard_grads"].items():
        if tp.param_spec(name) is None:
            for out in outs[1:]:
                assert torch.equal(out["shard_grads"][name], g), name
