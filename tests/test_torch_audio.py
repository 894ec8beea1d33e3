"""The port's audio path (models/wav2vec2.py, models/audio_encoder.py,
data/speech.load_audio) against Hugging Face's torch Wav2Vec2 (random tiny
config, as tests/test_wav2vec2.py) and the JAX package's counterparts."""

import json
import wave

import jax
import numpy as np
import pytest
import torch

from audio_motion_avatar_tpu.models import audio_encoder as jax_audio
from audio_motion_avatar_tpu.models import wav2vec2 as jax_w2v
from audio_motion_avatar_tpu_torch.models import audio_encoder
from audio_motion_avatar_tpu_torch.models import wav2vec2
from torch_parity import one_torch_thread  # noqa: F401

TINY = dict(hidden_size=24, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=48, conv_dim=(8,) * 7,
            conv_kernel=(10, 3, 3, 3, 3, 2, 2), conv_stride=(5, 2, 2, 2, 2, 2, 2),
            num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
            conv_bias=False)


def _hf(seed=0, **kw):
    from transformers import Wav2Vec2Config, Wav2Vec2Model
    torch.manual_seed(seed)
    cfg = Wav2Vec2Config(do_stable_layer_norm=False, feat_extract_norm="group",
                         vocab_size=32, **dict(TINY, **kw))
    return Wav2Vec2Model(cfg).eval()


def _wav(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def _port(hf):
    m = wav2vec2.Wav2Vec2Base(wav2vec2.Wav2Vec2ArchConfig(**TINY))
    m.load_state_dict(wav2vec2.state_dict_from_checkout(hf.state_dict()), strict=True)
    return m.eval()


@pytest.mark.parametrize("n", [3200, 5333])
def test_forward_matches_hf(n):
    hf = _hf()
    wav = _wav(n)
    with torch.no_grad():
        want = hf(torch.from_numpy(wav)[None]).last_hidden_state.numpy()[0]
        got = _port(hf)(torch.from_numpy(wav)[None]).numpy()[0]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


def test_forward_matches_jax_on_the_same_weights():
    hf = _hf(seed=3)
    sd = {k: v.numpy() for k, v in hf.state_dict().items()}
    wav = _wav(4000, seed=3)
    acfg = jax_w2v.Wav2Vec2ArchConfig(**TINY)
    want = np.asarray(jax_w2v.FlaxWav2Vec2Base(acfg).apply(
        jax_w2v.convert_torch_state_dict(sd, acfg), wav[None]))[0]
    with torch.no_grad():
        got = _port(hf)(torch.from_numpy(wav)[None]).numpy()[0]
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_pos_conv_weight_matches_jax():
    sd = _hf(seed=4).state_dict()
    want = jax_w2v._pos_conv_weight({k: v.numpy() for k, v in sd.items()})
    np.testing.assert_allclose(wav2vec2.pos_conv_weight(sd).numpy(), want, rtol=1e-6, atol=1e-7)
    legacy = {k: v for k, v in sd.items() if "parametrizations" not in k}
    legacy["encoder.pos_conv_embed.conv.weight_g"] = \
        sd["encoder.pos_conv_embed.conv.parametrizations.weight.original0"]
    legacy["encoder.pos_conv_embed.conv.weight_v"] = \
        sd["encoder.pos_conv_embed.conv.parametrizations.weight.original1"]
    np.testing.assert_array_equal(wav2vec2.pos_conv_weight(legacy).numpy(),
                                  wav2vec2.pos_conv_weight(sd).numpy())


@pytest.mark.parametrize("safe", [True, False], ids=["safetensors", "bin"])
def test_checkout_loads_and_matches(tmp_path, safe):
    """A save_pretrained checkout in either form loads by name (without
    transformers or safetensors) and matches HF on the processor's
    normalization."""
    hf = _hf(seed=1)
    hf.save_pretrained(tmp_path, safe_serialization=safe)
    with open(tmp_path / "preprocessor_config.json", "w") as f:
        json.dump({"do_normalize": True}, f)
    assert (tmp_path / ("model.safetensors" if safe else "pytorch_model.bin")).exists()
    model, do_normalize = wav2vec2.load_wav2vec2(str(tmp_path))
    assert do_normalize
    normed = wav2vec2.zero_mean_unit_var(_wav(2400, seed=1))
    with torch.no_grad():
        want = hf(torch.from_numpy(normed)[None]).last_hidden_state.numpy()[0]
        got = model(torch.from_numpy(normed)[None]).numpy()[0]
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


def test_safetensors_reader_matches_library(tmp_path):
    from safetensors.torch import load_file, save_file
    tensors = {"a": torch.randn(3, 4), "b": torch.arange(5, dtype=torch.int64),
               "c": torch.randn(2, 2).to(torch.bfloat16), "d": torch.zeros(0, 3)}
    save_file(tensors, str(tmp_path / "x.safetensors"))
    got = wav2vec2.read_safetensors(str(tmp_path / "x.safetensors"))
    want = load_file(str(tmp_path / "x.safetensors"))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])


def test_stable_layer_norm_refused(tmp_path):
    for extra, match in (({"do_stable_layer_norm": True}, "stable"),
                         ({"feat_extract_norm": "layer"}, "group")):
        path = tmp_path / "config.json"
        path.write_text(json.dumps(dict(hidden_size=24, **extra)))
        with pytest.raises(ValueError, match=match):
            wav2vec2.Wav2Vec2ArchConfig.from_json(str(path))
    path.write_text(json.dumps(dict(TINY, conv_dim=[8] * 7)))
    assert wav2vec2.Wav2Vec2ArchConfig.from_json(str(path)) == wav2vec2.Wav2Vec2ArchConfig(**TINY)


@pytest.mark.parametrize("frames", [8, 13, 30])
def test_features_match_jax_hf_path(tmp_path, frames):
    hf = _hf(seed=2)
    hf.save_pretrained(tmp_path)
    wav = _wav(int(16000 * frames / 24) - 500, seed=2) * 0.3
    want = jax_audio.AudioFeatureExtractor(model_path=str(tmp_path), dim=24) \
        .features_per_video_frame(wav, frames, 24)
    ext = audio_encoder.AudioFeatureExtractor(model_path=str(tmp_path), dim=24, device="cpu")
    assert isinstance(ext.encoder, wav2vec2.Wav2Vec2Base)
    got = ext.features_per_video_frame(wav, frames, 24)
    assert got.shape == want.shape == (frames, 24)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("frames", [8, 30])
def test_features_match_jax_fallback(frames):
    """The untrained conv fallback, with the JAX fallback's parameters
    carried over: the same pooled features. Both warn."""
    with pytest.warns(UserWarning, match="UNTRAINED conv fallback"):
        jext = jax_audio.AudioFeatureExtractor(model_path=None, dim=16)
    with pytest.warns(UserWarning, match="UNTRAINED conv fallback"):
        ext = audio_encoder.AudioFeatureExtractor(model_path="/nonexistent", dim=16,
                                                  device="cpu")
    assert isinstance(ext.encoder, audio_encoder.ConvAudioEncoder)
    params = jax.tree_util.tree_map(np.asarray, jext._vars)["params"]
    ext.encoder.load_state_dict(
        {f"conv{i}.{n}": torch.tensor(params[f"conv{i}"][k].transpose(2, 1, 0)
                                      if k == "kernel" else params[f"conv{i}"][k])
         for i in range(7) for n, k in (("weight", "kernel"), ("bias", "bias"))},
        strict=True)
    wav = _wav(int(16000 * frames / 24), seed=5) * 0.3
    want = jext.features_per_video_frame(wav, frames, 24)
    got = ext.features_per_video_frame(wav, frames, 24)
    assert got.shape == want.shape == (frames, 16)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_extractor_defaults_to_the_card():
    """Without device="cpu" the extractor asks for CUDA, which raises here."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="CUDA"):
        audio_encoder.AudioFeatureExtractor(dim=16)


@pytest.mark.parametrize("sr_in,sr_out", [(16000, 16000), (44100, 16000), (8000, 16000),
                                          (22050, 24000)])
def test_resample_linear_matches_jax(sr_in, sr_out):
    wav = _wav(sr_in // 3, seed=6)
    got = audio_encoder.resample_linear(wav, sr_in, sr_out)
    np.testing.assert_array_equal(got, jax_audio.resample_linear(wav, sr_in, sr_out))
    assert got.dtype == np.float32


def test_zero_mean_unit_var_matches_jax():
    wav = _wav(5000, seed=7) * 3 + 1
    np.testing.assert_array_equal(wav2vec2.zero_mean_unit_var(wav),
                                  jax_w2v.zero_mean_unit_var(wav))


def _write_wav(path, data, width, channels, sr=16000):
    with wave.open(str(path), "wb") as wf:
        wf.setnchannels(channels)
        wf.setsampwidth(width)
        wf.setframerate(sr)
        wf.writeframes(data.tobytes())


@pytest.mark.parametrize("width", [1, 2, 4])
@pytest.mark.parametrize("channels", [1, 2])
def test_load_audio_matches_jax(tmp_path, width, channels):
    from audio_motion_avatar_tpu.data.speech import load_audio as jax_load
    from audio_motion_avatar_tpu_torch.data.speech import load_audio
    rng = np.random.RandomState(width * 10 + channels)
    n = 1000 * channels
    data = {1: rng.randint(0, 256, n).astype(np.uint8),
            2: rng.randint(-32768, 32768, n).astype("<i2"),
            4: rng.randint(-2**31, 2**31, n, dtype=np.int64).astype("<i4")}[width]
    path = tmp_path / f"w{width}c{channels}.wav"
    _write_wav(path, data, width, channels, sr=22050)
    got, sr = load_audio(str(path))
    want, want_sr = jax_load(str(path))
    assert sr == want_sr == 22050 and got.shape == (1000,)
    np.testing.assert_array_equal(got, want)


def test_write_wav_round_trip(tmp_path):
    from audio_motion_avatar_tpu_torch.data.speech import load_audio, write_wav
    wav = np.clip(_wav(1600, seed=8) * 0.3, -1, 1)
    write_wav(str(tmp_path / "x.wav"), wav)
    got, sr = load_audio(str(tmp_path / "x.wav"))
    assert sr == 16000
    # rounding to 16 bits (0.5 / 32768) and the 32767 / 32768 scale (|x| / 32768)
    np.testing.assert_allclose(got, wav, atol=1.5 / 32768 + 1e-9, rtol=0)


def test_load_audio_refuses_without_ffmpeg(tmp_path, monkeypatch):
    from audio_motion_avatar_tpu_torch.data import speech
    monkeypatch.setattr(speech.shutil, "which", lambda name: None)
    (tmp_path / "x.mp3").write_bytes(b"not audio")
    with pytest.raises(RuntimeError, match="ffmpeg"):
        speech.load_audio(str(tmp_path / "x.mp3"))


def test_task_checkout_loads_the_encoder(tmp_path):
    """A checkout of a task model (as facebook/wav2vec2-base-960h is, a
    Wav2Vec2ForCTC: the encoder under `wav2vec2.`, an lm_head beside it)
    loads the encoder."""
    from transformers import Wav2Vec2Config, Wav2Vec2ForCTC
    torch.manual_seed(4)
    ctc = Wav2Vec2ForCTC(Wav2Vec2Config(do_stable_layer_norm=False, feat_extract_norm="group",
                                        vocab_size=32, **TINY)).eval()
    ctc.save_pretrained(tmp_path, safe_serialization=False)
    model, _ = wav2vec2.load_wav2vec2(str(tmp_path))
    wav = _wav(3000, seed=4)
    with torch.no_grad():
        want = ctc.wav2vec2(torch.from_numpy(wav)[None]).last_hidden_state.numpy()[0]
        got = model(torch.from_numpy(wav)[None]).numpy()[0]
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)
