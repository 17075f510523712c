"""The port's text path against the JAX package: the tokenizer, the CLIP text
tower, and the model and pipeline under [T, F, T] gating, where the mid
stage's cross-attention reads the text tokens.

Both packages get the same weights (the JAX package's ``init``, carried
across by the port's checkpoint/convert.py) and the same numpy inputs; the
port runs on the CPU.  Bars: 5e-5 for the text tower (the block bar of
tests/test_block_parity.py), MAE <= 1e-4 for the whole forward
(tests/test_assembled_parity.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdmatte_tpu.configs import CLIPTextConfig as JaxCLIPTextConfig
from sdmatte_tpu.configs import SDMatteConfig as JaxSDMatteConfig
from sdmatte_tpu.models import clip as jax_clip
from sdmatte_tpu.models import sdmatte as jax_sdmatte
from sdmatte_tpu.models import tokenizer as jax_tokenizer
from sdmatte_tpu.pipeline import MattingPipeline as JaxPipeline
from sdmatte_tpu.pipeline import PipelineOptions as JaxOptions
from test_clip import toy_vocab  # noqa: F401  (fixture)
from test_tokenizer_unicode import SAMPLES, _random_strings
from test_torch_models import _nchw, _nhwc, _randomized_params

from sdmatte_tpu_torch.checkpoint.convert import load_params, params_to_state_dict
from sdmatte_tpu_torch.configs import CLIPTextConfig, SDMatteConfig
from sdmatte_tpu_torch.core.dtypes import BF16
from sdmatte_tpu_torch.models import tokenizer
from sdmatte_tpu_torch.models.clip import CLIPTextModel
from sdmatte_tpu_torch.models.sdmatte import SDMatte
from sdmatte_tpu_torch.pipeline import MattingPipeline, PipelineOptions

TOY_TEXTS = ["", "hello world", "a cat, the dog!", "matting  with   spaces",
             "HELLO World", "cat41dog", "cat,,.world", "a_cat", "it's the cat's",
             "cat &amp;amp; dog", "!hello! <|endoftext|> world", "hello " * 200]
GATING = dict(use_encoder_hidden_states_list=(True, False, True),
              use_attention_mask_list=(True, False, True))


def _tokenizers(toy_vocab):
    vocab_file, merges_file = toy_vocab
    return (tokenizer.CLIPTokenizer(vocab_file, merges_file, pad_token="!"),
            jax_tokenizer.CLIPTokenizer(vocab_file, merges_file, pad_token="!"))


@pytest.mark.parametrize("text", TOY_TEXTS + SAMPLES)
def test_tokenizer_matches_jax(toy_vocab, text):  # noqa: F811
    ours, ref = _tokenizers(toy_vocab)
    assert ours([text]) == ref([text])
    assert tokenizer._split_words(text.lower()) == jax_tokenizer._split_words(text.lower())


def test_tokenizer_splits_codepoint_soup_as_jax():
    for s in _random_strings(1200):
        t = tokenizer._whitespace_clean(s).lower()
        assert tokenizer._split_words(t) == jax_tokenizer._split_words(t), t


def test_tokenizer_from_pretrained_dir_reads_pad_token(toy_vocab, tmp_path):  # noqa: F811
    import json
    import shutil
    vocab_file, merges_file = toy_vocab
    shutil.copy(vocab_file, tmp_path / "vocab.json")
    shutil.copy(merges_file, tmp_path / "merges.txt")
    (tmp_path / "tokenizer_config.json").write_text(json.dumps({"pad_token": {"content": "a"}}))
    ours = tokenizer.CLIPTokenizer.from_pretrained_dir(str(tmp_path))
    ref = jax_tokenizer.CLIPTokenizer.from_pretrained_dir(str(tmp_path))
    assert ours.pad_token == "a"
    assert ours(["hello cat", ""]) == ref(["hello cat", ""])


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_clip_matches_jax(rng, act):
    jcfg = dataclasses.replace(JaxCLIPTextConfig.tiny(), hidden_act=act)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.normal(0, 0.05, np.shape(x)).astype(np.float32),
        jax_clip.init(jcfg, seed=0))
    model = CLIPTextModel(dataclasses.replace(CLIPTextConfig.tiny(), hidden_act=act))
    model.load_state_dict(params_to_state_dict(params), strict=True)
    ids = rng.integers(0, jcfg.vocab_size, (2, 77)).astype(np.int32)
    ref = np.asarray(jax_clip.apply(params, jnp.asarray(ids), jcfg))
    with torch.no_grad():
        got = model(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, ref, atol=5e-5, rtol=1e-4)


def test_clip_bf16_matches_jax_bf16(rng):
    """The bf16 policy: bf16 activations, fp32 scores and statistics."""
    from sdmatte_tpu.core.dtypes import BF16 as JAX_BF16
    jcfg = JaxCLIPTextConfig.tiny()
    params = jax_clip.init(jcfg, seed=1)
    model = CLIPTextModel(CLIPTextConfig.tiny())
    model.load_state_dict(params_to_state_dict(params), strict=True)
    ids = rng.integers(0, jcfg.vocab_size, (2, 77)).astype(np.int32)
    ref = np.asarray(jax_clip.apply(params, jnp.asarray(ids), jcfg, policy=JAX_BF16), np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(ids), policy=BF16)
    assert got.dtype == torch.bfloat16
    assert float(np.abs(got.float().numpy() - ref).mean()) <= 1e-2


@pytest.fixture(scope="module")
def gated():
    jcfg = JaxSDMatteConfig.tiny()
    jcfg = dataclasses.replace(jcfg, unet=dataclasses.replace(jcfg.unet, **GATING))
    cfg = SDMatteConfig.tiny()
    cfg = dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet, **GATING))
    params = _randomized_params(jcfg, seed=3)
    return jcfg, params, load_params(SDMatte(cfg), params).eval()


def test_gated_forward_matches_jax(gated, rng):
    jcfg, params, model = gated
    b, s = 2, 64
    data = {
        "image": rng.uniform(-1, 1, (b, s, s, 3)).astype(np.float32),
        "trimap": rng.choice([-1.0, 0.0, 1.0], (b, s, s, 1)).astype(np.float32),
        "trimap_coords": rng.uniform(0, 1, (b, 4)).astype(np.float32),
        "is_trans": np.array([0.0, 1.0], np.float32),
        "text_ids": np.array([[1, 5, 9, 7] + [0] * 73, [2, 3, 4, 8, 6, 1, 9, 5] + [0] * 69],
                             np.int32),
    }
    ref = np.asarray(jax.jit(lambda p, d: jax_sdmatte.forward(p, jcfg, d, attn_impl="xla"))(
        params, {k: jnp.asarray(v) for k, v in data.items()}))
    tdata = {k: (_nchw(v) if v.ndim == 4 else torch.from_numpy(v)) for k, v in data.items()}
    with torch.no_grad():
        got = _nhwc(model(tdata))
    mae = float(np.abs(got - ref).mean())
    assert mae <= 1e-4, mae


def test_gated_pipeline_matches_jax(gated, toy_vocab):  # noqa: F811
    jcfg, params, model = gated
    ours_tok, ref_tok = _tokenizers(toy_vocab)
    rng = np.random.default_rng(5)
    img = rng.uniform(0, 1, (2, 70, 66, 3)).astype(np.float32)
    tri = rng.choice([0.0, 0.5, 1.0], (2, 70, 66)).astype(np.float32)
    kw = dict(inference_size=64, mask_refine=False)
    caption = ["hello cat", "the dog"]
    jax_pipe = JaxPipeline(params, jcfg, attn_impl="xla", tokenizer=ref_tok)
    ref, _ = jax_pipe(img, tri, options=JaxOptions(**kw), caption=caption)
    pipe = MattingPipeline(model, device="cpu", tokenizer=ours_tok)
    got, _ = pipe(img, tri, options=PipelineOptions(**kw), caption=caption)
    assert float(np.abs(got.numpy() - np.asarray(ref)).mean()) <= 1e-4
    # the caption reaches the model: another one gives another matte
    other, _ = pipe(img, tri, options=PipelineOptions(**kw))
    assert float(np.abs(other.numpy() - got.numpy()).max()) > 0
    with pytest.raises(ValueError, match="tokenizer"):
        MattingPipeline(model, device="cpu")(img, tri, options=PipelineOptions(**kw))
