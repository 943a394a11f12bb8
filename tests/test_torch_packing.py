"""The port's caption packing (dclip_tpu_torch.ops.packing, host numpy
copied from the JAX module) against `dclip_tpu.ops.packing`, and the packed
text tower against the unpacked one and against the JAX module's
`get_packed_text_features`, on the CPU."""
import numpy as np
import pytest
import torch

from dclip_tpu.core.config import CLIPConfig
from dclip_tpu.ops import packing as jpacking
from dclip_tpu_torch.ops import packing

import torch_parity

EMB_TOL = dict(rtol=1e-4, atol=1e-5)  # 2-layer towers at f32, as test_torch_clip


def _captions(b=12, t=16, eos=999, seed=0, no_eos_row=True):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, eos - 2, size=(b, t)).astype(np.int32)
    mask = np.zeros((b, t), np.int32)
    for r, n in enumerate(rng.randint(1, t + 1, size=b)):
        mask[r, :n] = 1
        ids[r, n:] = 0
        if not (no_eos_row and r == 0):
            ids[r, n - 1] = eos
    return ids, mask


@pytest.mark.parametrize("n_shards,rows", [(1, 0), (2, 0), (3, 0), (2, 6)])
def test_packing_arrays_equal_jax(n_shards, rows):
    ids, mask = _captions()
    got = packing.pack_captions_sharded(ids, mask, 999, n_shards, rows_per_shard=rows)
    want = jpacking.pack_captions_sharded(ids, mask, 999, n_shards, rows_per_shard=rows)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    g2, w2 = (m.globalize_eos_rows(x, n_shards, first_shard=1)
              for m, x in ((packing, got), (jpacking, want)))
    np.testing.assert_array_equal(g2["packed_eos_rows"], w2["packed_eos_rows"])
    assert packing.min_rows_sharded(ids, mask, 999, n_shards) == \
        jpacking.min_rows_sharded(ids, mask, 999, n_shards)
    one, jone = packing.pack_captions(ids, mask, 999), jpacking.pack_captions(ids, mask, 999)
    for k in jone:
        np.testing.assert_array_equal(one[k], jone[k], err_msg=k)


def test_rows_bucket_and_bias_equal_jax():
    for m in range(0, 40):
        for b in (1, 7, 8, 32):
            assert packing.packed_rows_bucket(m, b) == jpacking.packed_rows_bucket(m, b)
    seg = packing.pack_captions(*_captions(seed=1), 999)["packed_segments"]
    np.testing.assert_array_equal(packing.packed_attention_bias(torch.from_numpy(seg)).numpy(),
                                  np.asarray(jpacking.packed_attention_bias(seg)))


@pytest.fixture(scope="module")
def tiny():
    cfg = CLIPConfig.tiny_test()
    model, params = torch_parity.jax_clip(cfg, seed=0)
    return cfg, model, params


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_packed_text_features_match_unpacked_and_jax(tiny, fused):
    from dclip_tpu.models.clip import CLIPModule as JaxCLIPModule
    from dclip_tpu_torch.models.clip import CLIPModule
    from dclip_tpu_torch.models.weights import state_dict_from_jax

    cfg, _, params = tiny
    ids, mask = _captions(8, cfg.text.max_length, cfg.text.eos_token_id, seed=2,
                          no_eos_row=False)
    packed = packing.pack_captions(ids, mask, cfg.text.eos_token_id)
    assert packed["packed_ids"].shape[0] < 8
    port = CLIPModule(cfg, device="meta", fused_attention=fused)
    port.load_state_dict(state_dict_from_jax(params, cfg), assign=True)
    keys = ("packed_ids", "packed_segments", "packed_positions", "packed_eos_rows",
            "packed_eos_cols")
    with torch.no_grad():
        got = port.get_packed_text_features(*(torch.from_numpy(packed[k]) for k in keys))
        unpacked = port.get_text_features(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), unpacked.numpy(), **EMB_TOL)
    jm = JaxCLIPModule(cfg, fused_attention=fused, pallas_interpret=True)
    want = jm.apply({"params": params}, *(packed[k] for k in keys),
                    method=jm.get_packed_text_features)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **EMB_TOL)
