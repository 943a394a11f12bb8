"""The port's BERT branch and complexity scorer against the JAX package on
the CPU:

- `models.bert.BertEncoder` at `BertConfig.tiny_test()` on the JAX params
  carried across (`models.weights.bert_state_dict_from_jax`): last hidden
  state and pooled output within 1e-5 of JAX's `BertEncoder`, with padding
  in the mask;
- a `transformers.BertModel` state dict (tiny config) loaded strict, with
  and without the `bert.` prefix, within 1e-5 of that model;
  `load_bert_pretrained` on `.safetensors`, `.bin` and a directory;
- `bert_to_clip_features` through `TextProjectionModule` against JAX's;
- `data.bert_tokenizer.BertWordPieceTokenizer`: ids and masks equal to
  JAX's and `transformers.BertTokenizer`'s on the same vocabulary, on fixed
  strings and a hypothesis fuzz over JAX's hostile pool
  (`tests/test_bert.py`);
- `data.text_complexity`: scores equal to JAX's, exactly, on fake
  tokenizers, a GloVe-format file, and the port's `CLIPTokenizer` against
  JAX's on the same BPE files.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers
from hypothesis import given, settings
from hypothesis import strategies as st

from dclip_tpu.data import bert_tokenizer as jtok
from dclip_tpu.data import text_complexity as jtc
from dclip_tpu.data.tokenizer import CLIPTokenizer as JaxCLIPTokenizer
from dclip_tpu.models import bert as jbert
from dclip_tpu.models.projections import TextProjectionModule as JaxTextProjection
from dclip_tpu_torch.data import bert_tokenizer, text_complexity
from dclip_tpu_torch.data.tokenizer import CLIPTokenizer
from dclip_tpu_torch.models import bert
from dclip_tpu_torch.models.projections import TextProjectionModule
from dclip_tpu_torch.models.weights import bert_state_dict_from_jax, projection_state_dict_from_jax

from test_tokenizer import _tiny_vocab_files

TOL = dict(rtol=0, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _ids_and_mask(cfg, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg.vocab_size, size=(3, 12)).astype(np.int32)
    mask = np.ones((3, 12), np.int32)
    mask[1, 8:] = 0
    mask[2, 5:] = 0
    return ids, mask


@pytest.fixture(scope="module")
def jax_pair():
    """(config, JAX module, JAX params from numpy: Dense kernels at
    1/sqrt(fan_in), biases N(0, 0.1), embeddings N(0, 0.5), LayerNorm
    scales 1 + N(0, 0.1))."""
    cfg = jbert.BertConfig.tiny_test()
    model = jbert.BertEncoder(cfg)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                               jnp.zeros((1, 4), jnp.int32)))["params"]
    rng = np.random.RandomState(0)

    def fill(path, s):
        name = str(path[-1].key) if hasattr(path[-1], "key") else ""
        if name == "kernel":
            x = rng.standard_normal(s.shape) * s.shape[0] ** -0.5
        elif name == "scale":
            x = 1 + 0.1 * rng.standard_normal(s.shape)
        elif name in ("embedding", "position_embeddings"):
            x = 0.5 * rng.standard_normal(s.shape)
        else:
            x = 0.1 * rng.standard_normal(s.shape)
        return x.astype(np.float32)

    return cfg, model, jax.tree_util.tree_map_with_path(fill, shapes)


def _port(cfg, sd):
    model = bert.BertEncoder(bert.BertConfig(**cfg.__dict__), device="meta")
    model.load_state_dict(sd, strict=True, assign=True)
    return model.eval()


def test_encoder_matches_jax(jax_pair):
    cfg, model, params = jax_pair
    ids, mask = _ids_and_mask(cfg)
    want_h, want_p = model.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask))
    port = _port(cfg, bert_state_dict_from_jax(params, cfg))
    with torch.no_grad():
        h, p = port(_t(ids), _t(mask))
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), **TOL)
    np.testing.assert_allclose(p.numpy(), np.asarray(want_p), **TOL)
    with torch.no_grad():  # no mask: every key attends
        h, _ = port(_t(ids))
    want_h, _ = model.apply({"params": params}, jnp.asarray(ids))
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), **TOL)


def test_bert_to_clip_features_matches_jax(jax_pair):
    cfg, model, params = jax_pair
    ids, mask = _ids_and_mask(cfg, seed=1)
    proj = JaxTextProjection(clip_dim=16, hidden_dim=24)
    pparams = proj.init(jax.random.PRNGKey(3), jnp.zeros((1, cfg.hidden_size)))["params"]
    want = jbert.bert_to_clip_features(model, params, lambda x: proj.apply({"params": pparams}, x),
                                       jnp.asarray(ids), jnp.asarray(mask))
    head = TextProjectionModule(clip_dim=16, hidden_dim=24, bert_dim=cfg.hidden_size)
    head.load_state_dict(projection_state_dict_from_jax(pparams), strict=True)
    with torch.no_grad():
        got = bert.bert_to_clip_features(_port(cfg, bert_state_dict_from_jax(params, cfg)), head,
                                         _t(ids), _t(mask))
    assert got.shape == (3, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def hf_model():
    cfg = bert.BertConfig.tiny_test()
    hf_cfg = transformers.BertConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        num_hidden_layers=cfg.num_layers, num_attention_heads=cfg.num_heads,
        intermediate_size=cfg.mlp_dim, max_position_embeddings=cfg.max_length,
        type_vocab_size=cfg.type_vocab_size, hidden_act="gelu",
        attention_probs_dropout_prob=0.0, hidden_dropout_prob=0.0)
    torch.manual_seed(0)
    return cfg, transformers.BertModel(hf_cfg).eval()


@pytest.mark.parametrize("prefix", ["", "bert."])
def test_transformers_state_dict_loads_strict(hf_model, prefix):
    cfg, hf = hf_model
    sd = {f"{prefix}{k}": v for k, v in hf.state_dict().items()}
    if prefix:  # a BertForPreTraining-style file: heads beside the encoder
        sd["cls.predictions.bias"] = torch.zeros(cfg.vocab_size)
        sd[f"{prefix}embeddings.position_ids"] = torch.arange(cfg.max_length)[None]
    model = bert.BertEncoder(cfg).eval()
    model.load_state_dict(bert.convert_bert_state_dict(sd, cfg), strict=True)
    ids, mask = _ids_and_mask(cfg, seed=2)
    with torch.no_grad():
        want = hf(input_ids=_t(ids).long(), attention_mask=_t(mask).long())
        h, p = model(_t(ids), _t(mask))
    np.testing.assert_allclose(h.numpy(), want.last_hidden_state.numpy(), **TOL)
    np.testing.assert_allclose(p.numpy(), want.pooler_output.numpy(), **TOL)


def test_convert_refuses_a_short_state_dict(hf_model):
    cfg, hf = hf_model
    sd = {k: v for k, v in hf.state_dict().items() if not k.startswith("encoder.layer.1.")}
    with pytest.raises(KeyError, match="2 layers"):
        bert.convert_bert_state_dict(sd, cfg)


@pytest.mark.parametrize("form", ["safetensors", "bin", "dir"])
def test_load_bert_pretrained_reads_local_files(hf_model, tmp_path, form):
    from safetensors.torch import save_file

    cfg, hf = hf_model
    sd = {k: v.contiguous() for k, v in hf.state_dict().items()}
    if form == "safetensors":
        path = str(tmp_path / "model.safetensors")
        save_file(sd, path)
    elif form == "bin":
        path = str(tmp_path / "pytorch_model.bin")
        torch.save(sd, path)
    else:
        hf.save_pretrained(str(tmp_path))
        path = str(tmp_path)
    loaded = bert.load_bert_pretrained(path, cfg)
    assert set(loaded) == set(bert.BertEncoder(cfg, device="meta").state_dict())
    for k, v in loaded.items():
        np.testing.assert_array_equal(v.numpy(), sd[k].numpy(), err_msg=k)


# -- WordPiece ---------------------------------------------------------------------------

WP_TOKENS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "the", "cat", "dog", "run", "##ning",
             "##s", "##ed", "jump", "a", "photo", "of", "un", "##believ", "##able", "over",
             ",", ".", "!", "?", "-", "'", '"', "naive", "cafe", "hello", "world", "12", "##3",
             "中", "国"]
TEXTS = ["The cat runs over the dog!", "a photo of a running cat, unbelievable.",
         "naïve café-dog 123", "hello 中国 world", "  whitespace\t\teverywhere   ",
         "unknownword the", "", "[MASK] the [CLS] cat", "the cat " * 20]
# tests/test_bert.py's hostile pool: ASCII, punctuation, accents, CJK,
# Hangul, emoji, a zero-width space and a no-break space.
POOL = ("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
        " \t\n  .,!?;:'\"-()[]/&%$#@*+=<>"
        "àéîöüñçß"
        "中国日本語한국"
        "🙂🚀"
        "​ ")


@pytest.fixture(scope="module")
def wordpiece(tmp_path_factory):
    path = tmp_path_factory.mktemp("wp") / "vocab.txt"
    path.write_text("\n".join(WP_TOKENS) + "\n", encoding="utf-8")
    return (bert_tokenizer.BertWordPieceTokenizer.from_vocab_file(str(path), max_length=16),
            jtok.BertWordPieceTokenizer.from_vocab_file(str(path), max_length=16),
            transformers.BertTokenizer(vocab_file=str(path), do_lower_case=True))


def _hold_wordpiece(wordpiece, text):
    port, jax_tok, hf = wordpiece
    ids, mask = port.encode(text)
    want_ids, want_mask = jax_tok.encode(text)
    assert ids.dtype == mask.dtype == np.int32
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(mask, want_mask)
    hf_out = hf(text, padding="max_length", truncation=True, max_length=16)
    assert list(ids) == hf_out["input_ids"], repr(text)
    assert list(mask) == hf_out["attention_mask"], repr(text)
    assert port.tokenize(text) == jax_tok.tokenize(text)
    assert port.decode(ids) == jax_tok.decode(ids)


@pytest.mark.parametrize("text", TEXTS)
def test_wordpiece_matches_jax_and_transformers(wordpiece, text):
    _hold_wordpiece(wordpiece, text)


@settings(max_examples=150, deadline=None, derandomize=True, database=None)
@given(st.text(alphabet=POOL, max_size=40))
def test_wordpiece_fuzz_matches_jax_and_transformers(wordpiece, text):
    _hold_wordpiece(wordpiece, text)


def test_wordpiece_batch_and_the_encoder(wordpiece, hf_model):
    """string -> ids -> BertEncoder -> pooled: the batch form equals the
    rows, and the ids run through the encoder."""
    port, jax_tok, _ = wordpiece
    ids, mask = port.encode_batch(TEXTS[:3], max_length=12)
    want = jax_tok.encode_batch(TEXTS[:3], max_length=12)
    np.testing.assert_array_equal(ids, want[0])
    np.testing.assert_array_equal(mask, want[1])
    cfg, hf = hf_model
    model = bert.BertEncoder(cfg).eval()
    model.load_state_dict(bert.convert_bert_state_dict(hf.state_dict(), cfg))
    with torch.no_grad():
        _, pooled = model(_t(ids), _t(mask))
    assert pooled.shape == (3, cfg.hidden_size) and torch.isfinite(pooled).all()


# -- complexity scorer -------------------------------------------------------------------


class _LengthTok:
    def tokenize(self, w):
        return [0] * max(len(w) // 3, 1)


class _OneTok:
    def tokenize(self, w):
        return [0]


WORDS = ["cat", "abcdef", "abcdefghi", "abcdefghijklmnop", "kitten,", "Feline!", "zebra", "dog",
         "ox", "", "...", "photographer", "the", "a"]
GLOVE = "cat 1.0 0.0\nkitten 0.99 0.1\nfeline 0.98 0.15\ndog 0.2 0.9\n"


@pytest.fixture(scope="module")
def glove(tmp_path_factory):
    path = tmp_path_factory.mktemp("glove") / "glove.txt"
    path.write_text(GLOVE)
    return str(path)


def _scorers(port_tok, jax_tok, glove=None, **kw):
    pv = text_complexity.WordVectors.load_glove_txt(glove) if glove else None
    jv = jtc.WordVectors.load_glove_txt(glove) if glove else None
    return (text_complexity.ComplexityScorer(port_tok, pv, **kw),
            jtc.ComplexityScorer(jax_tok, jv, **kw))


def _hold_scores(port, jax_scorer):
    for w in WORDS:
        assert port.compute_word_complexity(w) == jax_scorer.compute_word_complexity(w), w
    text = " ".join(WORDS)
    assert port.mark_complex_words(text) == jax_scorer.mark_complex_words(text)


@pytest.mark.parametrize("tok", [_LengthTok, _OneTok])
@pytest.mark.parametrize("vectors", [False, True], ids=["no_vectors", "glove"])
def test_complexity_scores_equal_jax(glove, tok, vectors):
    port, jax_scorer = _scorers(tok(), tok(), glove if vectors else None)
    _hold_scores(port, jax_scorer)
    if vectors and tok is _OneTok:  # JAX's own expectations hold on the port
        assert port.compute_word_complexity("cat") < 0.2
        assert np.isclose(port.compute_word_complexity("zebra"), 0.36)
        assert port.mark_complex_words("cat zebra") == "cat [MASK]"
    pv = text_complexity.WordVectors.load_glove_txt(glove)
    jv = jtc.WordVectors.load_glove_txt(glove)
    np.testing.assert_array_equal(pv.matrix, jv.matrix)
    assert pv.mean_top_similarity("cat", topn=2) == jv.mean_top_similarity("cat", topn=2)


@pytest.mark.parametrize("threshold", [0.35, 0.1])
def test_complexity_with_the_clip_tokenizer_equals_jax(glove, tmp_path, threshold):
    vocab, merges = _tiny_vocab_files(tmp_path)
    port_tok, jax_tok = CLIPTokenizer.from_files(vocab, merges), JaxCLIPTokenizer.from_files(
        vocab, merges)
    for w in WORDS:
        assert port_tok.tokenize(w) == jax_tok.tokenize(w)
    for vectors in (None, glove):
        port, jax_scorer = _scorers(port_tok, jax_tok, vectors, complexity_threshold=threshold)
        _hold_scores(port, jax_scorer)
