"""The PyTorch port's serving slice on the CPU: the config registry, audio
IO (WAV, FLAC and, where libmpg123 and libmp3lame load, MP3) and
resampling, ``load_model`` on a reference-layout Lightning checkpoint
against the JAX package's loader (the EMA-shadowed, folded weights, and
``enhance`` through the fused chain against JAX's packed ``enhance`` on the
same noise within 2e-5), the ``enhance`` flag reflection,
and the HTTP server: micro-batching, stereo, status codes, ``/stats``, the
warm-up grid, and a served result equal to a direct ``enhance`` with the
same generator state.
"""
import http.client
import io
import json
import threading
import urllib.request
import wave

import numpy as np
import pytest
from threadpoolctl import threadpool_limits
import yaml

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from open_universe_tpu.configs.registry import instantiate as jax_instantiate  # noqa: E402
from open_universe_tpu.data.audio import resample_audio as jax_resample  # noqa: E402
from open_universe_tpu.inference.model_loader import load_model as jax_load_model  # noqa: E402
from open_universe_tpu.inference.torch_convert import (  # noqa: E402
    ordered_param_names,
    to_torch_state_dict,
)
from open_universe_tpu_torch.bin.serve import EnhanceService, make_server  # noqa: E402
from open_universe_tpu_torch.configs.registry import instantiate  # noqa: E402
from open_universe_tpu_torch.data.audio import (  # noqa: E402
    load_audio,
    resample_audio,
    save_audio,
)
from open_universe_tpu_torch.inference import model_loader  # noqa: E402
from open_universe_tpu_torch.inference.signature_to_parser import (  # noqa: E402
    parse_with_enhance_args,
)
from open_universe_tpu_torch.nn.layers import init_weights  # noqa: E402
from open_universe_tpu_torch.ops.kernels import conv_block  # noqa: E402
from open_universe_tpu_torch.utils.convert import (  # noqa: E402
    fold_weight_norm,
    from_jax_params,
)

from test_checkpoint_conversion import TINY_GAN_CFG  # noqa: E402
from test_torch_codecs import mp3_libraries  # noqa: E402

FS = 16000
TOL = 2e-5
EMA_SUBS = ["_edm_model", "condition_model", "signal_decoupling_layer"]
# TINY_GAN_CFG with UNIVERSE++ networks of narrow width that JAX can run
# packed: the bottleneck (32 * 2 * 2 = 128 channels) has pack factor 1
_SCORE = dict(rate_factors=[2, 2], n_channels=32, noise_cond_dim=32,
              extra_conv_block=True, use_weight_norm=True, use_antialiasing=True,
              time_embedding="simple")
_COND = dict(rate_factors=[2, 2], n_channels=32, n_mels=16, n_mel_oversample=4,
             encoder_gru_residual=True, extra_conv_block=True, use_weight_norm=True)
SERVE_CFG = {
    **{k: v for k, v in TINY_GAN_CFG.items() if k not in ("score_model",
                                                            "condition_model")},
    "score_model": {"_target_": "open_universe.networks.universe.ScoreNetwork",
                    **_SCORE},
    "condition_model": {
        "_target_": "open_universe_tpu.networks.universe.ConditionerNetwork", **_COND},
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: these small tensors gain nothing from more, and
    more oversubscribe the cores the other test workers use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):  # numpy's BLAS too
        yield
    torch.set_num_threads(n)


def _wav_bytes(x, fs=FS):
    buf = io.BytesIO()
    from scipy.io import wavfile

    x = np.asarray(x)
    wavfile.write(buf, fs, (np.clip(x.T if x.ndim == 2 else x, -1, 1) * 32767)
                  .astype(np.int16))
    return buf.getvalue()


def _decode(body):
    with wave.open(io.BytesIO(body)) as w:
        n, ch = w.getnframes(), w.getnchannels()
        assert w.getframerate() == FS
        out = np.frombuffer(w.readframes(n), np.int16).reshape(n, ch).T
    return out.astype(np.float32) / 32768.0


def _post(url, body, path="/enhance"):
    req = urllib.request.Request(url + path, data=body,
                                 headers={"Content-Type": "audio/wav"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _stats(url):
    with urllib.request.urlopen(url + "/stats", timeout=30) as r:
        return json.loads(r.read())


# ---------------------------------------------------------------- registry, IO
def test_registry_builds_reference_configs_and_names_what_it_lacks(tmp_path, monkeypatch):
    model = instantiate(SERVE_CFG)
    assert model.use_signal_decoupling and model.with_edm and model.tot_ds == 4
    assert model.model_param_keys() == ("score_model", "condition_model",
                                        "signal_decoupling_layer")
    assert type(instantiate({"_target_": "open_universe_tpu.layers.dyn_range_comp."
                                         "IdentityTransform"})).__name__ == \
        "IdentityTransform"
    stft = {"_target_": "open_universe.layers.dyn_range_comp.CompressedMagSTFT",
            "stft_kwargs": {"n_fft": 510, "hop_length": 128, "window_name": "hann"},
            "spec_kwargs": {"transform_type": "exponent", "abs_exponent": 0.5,
                            "factor": 0.15}}
    assert type(instantiate({**SERVE_CFG, "transform": stft}).transform).__name__ == \
        "CompressedMagSTFT"
    # the phoneme loss resolves, and names the wav2vec2 files it lacks
    for var in ("HF_HUB_CACHE", "HF_HOME", "HOME"):
        monkeypatch.setenv(var, str(tmp_path))
    with pytest.raises(FileNotFoundError, match="config.json"):
        instantiate({**SERVE_CFG, "transform": {
            "_target_": "open_universe.losses.PhonemeCTCLoss"}})
    bad = {**SERVE_CFG, "losses": {"score_loss": {"_target_": "torch.nn.L1Loss"}}}
    with pytest.raises(NotImplementedError, match="MSE"):
        instantiate(bad)


def test_wav_io_and_resample(tmp_path, rng):
    x = (rng.standard_normal((2, 1000)) * 0.1).astype(np.float32)
    save_audio(tmp_path / "a.wav", x, 24000)
    y, fs = load_audio(tmp_path / "a.wav")
    assert fs == 24000 and y.shape == (2, 1000)
    np.testing.assert_allclose(y, x, atol=2.0 / 32767)  # int16 truncation and scale
    np.testing.assert_allclose(resample_audio(y, 24000, FS),
                               np.asarray(jax_resample(y, 24000, FS)), atol=1e-6)
    save_audio(tmp_path / "a.flac", x, 24000)  # lossless: the 16-bit samples
    y, fs = load_audio(tmp_path / "a.flac")
    assert fs == 24000 and y.shape == (2, 1000)
    np.testing.assert_array_equal(
        y, np.clip(np.round(x * 32768.0), -32768, 32767) / 32768.0)
    if mp3_libraries():
        save_audio(tmp_path / "a.mp3", x, 24000)  # lossy; the encoder pads frames
        y, fs = load_audio(tmp_path / "a.mp3")
        assert fs == 24000 and y.shape[0] == 2 and y.shape[1] >= 1000


# ------------------------------------------------------------------ load_model
def jax_enhance_and_noise(model, params, mix, key, n_steps, shape, **kwargs):
    """JAX ``enhance`` and its sampler draws (models/universe.py:565-577,608:
    the initial one, then the step-i draw from step_keys[n_loop + i]), in one
    jit."""
    def draws():
        n_loop = n_steps - 1
        k_init, k_loop = jax.random.split(key)
        step_keys = jax.random.split(k_loop, 2 * n_loop + 1)
        return [jax.random.normal(k_init, shape)] + [
            jax.random.normal(step_keys[n_loop + i], shape) for i in range(n_loop)]

    out, noise = jax.jit(lambda p, m: (
        model.enhance(p, m, key=key, n_steps=n_steps, **kwargs), draws()))(
        params, jnp.asarray(mix))
    return np.asarray(out), [np.array(z) for z in noise]


def test_load_model_matches_jax_loader(tmp_path, rng, monkeypatch, record_property):
    """The loaded model's ``enhance``, whose ConvBlocks all take the fused
    chain on (B, T, C) at batch 2, against JAX's packed ``enhance`` of its
    own loaded model, which packs the blocks of 32 and 64 channels."""
    jm = jax_instantiate(SERVE_CFG)
    params = {name: jax.tree_util.tree_map(
        lambda s: (rng.uniform(-1, 1, s.shape) / np.sqrt(np.prod(s.shape[:-1])))
        .astype(np.float32), jax.eval_shape(getattr(jm, name).init, jax.random.key(0)))
        for name in jm.model_param_keys()}
    sd = {k: torch.from_numpy(np.array(v)) for k, v in
          to_torch_state_dict(jm, params, edm=True).items()}
    names = ordered_param_names(sd, EMA_SUBS)
    assert any(n.startswith("signal_decoupling_layer.") for n in names)
    ema = {"shadow_params": [sd[n] * 0.5 + 0.01 for n in names], "decay": 0.999}
    torch.save({"state_dict": sd, "ema": ema}, tmp_path / "weights.ckpt")
    (tmp_path / "config.yaml").write_text(yaml.safe_dump({"model": SERVE_CFG}))

    # JAX's enhance takes weight-normed params as they are; its loader's
    # fold runs op by op (seconds on a CPU), so it is left out
    jm2, jparams = jax_load_model(str(tmp_path / "weights.ckpt"), fold_wn=False)
    want = instantiate(SERVE_CFG)
    from_jax_params(want, jax.tree_util.tree_map(
        np.asarray, {k: jparams[k] for k in jm2.model_param_keys()}))
    ckpt = tmp_path / "weights.ckpt"
    for fold in (False, True):
        got = model_loader.load_model(ckpt, fold_wn=fold, device="cpu").state_dict()
        if fold:
            fold_weight_norm(want)
        for k, v in want.state_dict().items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=1e-6, err_msg=k)
    model = model_loader.load_model(ckpt, device="cpu")
    raw = model_loader.load_model(ckpt, load_ema=False, device="cpu")
    assert not torch.allclose(raw.score_model.input_conv.weight,
                              model.score_model.input_conv.weight)

    b, t, n_steps = 2, 320, 2
    mix = np.random.default_rng(1).standard_normal((b, t)).astype(np.float32) * 0.1
    # 320 samples are padded by a full period of 4
    assert jm2.score_model.packed_eligible(324)
    assert jm2.condition_model.packed_eligible(324)
    ref, noise = jax_enhance_and_noise(jm2, jparams, mix, jax.random.key(1), n_steps,
                                       (b, 324, 1), packed=True)
    calls = []
    real = conv_block.fused_conv_chain_reference
    monkeypatch.setattr(conv_block, "fused_conv_chain_reference",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    out = model.enhance(mix, n_steps=n_steps, noise=noise)
    # the 6 ConvBlocks of each score pass and the conditioner's 10, the
    # blocks of 32 and 64 channels among them, which JAX packs
    assert len(calls) == 6 * n_steps + 10
    assert out.shape == (b, t) and torch.isfinite(out).all()
    record_property("max_abs_diff", float(np.abs(out.numpy() - ref).max()))
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=0)

    with pytest.raises(NotImplementedError, match="Orbax"):
        model_loader.load_model(tmp_path, device="cpu")
    (tmp_path / "config.yaml").unlink()
    with pytest.raises(FileNotFoundError):
        model_loader.ckpt_to_config_path(tmp_path / "weights.ckpt")


def test_enhance_flags_are_reflected():
    import argparse

    model = instantiate(SERVE_CFG)
    parser = argparse.ArgumentParser()
    parser.add_argument("--model")
    parser.add_argument("--device")
    seen = {}

    def loader(name, device=None):
        seen.update(name=name, device=device)
        return model

    args, got, kw = parse_with_enhance_args(
        parser, ["--model", "m.ckpt", "--device", "cpu", "--keep_rms", "1",
                 "--n_steps", "3"], loader)
    assert got is model and seen == {"name": "m.ckpt", "device": "cpu"}
    assert kw == {"n_steps": 3, "epsilon": 1.3, "keep_rms": True}
    flags = {a.dest for a in parser._actions}
    assert {"n_steps", "epsilon", "keep_rms", "fake_score_snr", "use_aux_signal",
            "ensemble", "ensemble_stat", "warm_start"} <= flags
    assert not flags & {"compute_dtype", "generator", "noise", "mix", "target",
                        "packed"}


# ---------------------------------------------------------------------- server
@pytest.fixture(scope="module")
def server():
    model = fold_weight_norm(init_weights(instantiate(SERVE_CFG), seed=0)).eval()
    # 3 batches wait out the window: 0.3 s of sleep in all
    srv, service = make_server(model, model_name="tiny", port=0, max_batch=4,
                               batch_window_ms=100.0, bucket_seconds=0.1,
                               max_clip_seconds=1.0, enhance_kwargs={"n_steps": 2})
    th = threading.Thread(target=srv.serve_forever, kwargs={"poll_interval": 0.05},
                          daemon=True)
    th.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", service
    srv.shutdown()
    service.close()


def test_healthz_and_404(server):
    url, _ = server
    with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
        meta = json.loads(r.read())
    assert meta["status"] == "ok" and meta["fs"] == FS and meta["device"] == "cpu"
    status, _ = _post(url, b"", path="/nope")
    assert status == 404


def test_burst_of_connections_is_accepted():
    """Connections made before the accept loop runs wait in the listen
    backlog instead of being dropped (socketserver's default holds 5)."""
    import socket

    srv, service = make_server(instantiate(SERVE_CFG), port=0)
    socks = [socket.create_connection(srv.server_address, timeout=1)
             for _ in range(12)]
    th = threading.Thread(target=srv.serve_forever, kwargs={"poll_interval": 0.05},
                          daemon=True)
    th.start()
    try:
        for s in socks:
            s.sendall(b"GET /healthz HTTP/1.0\r\n\r\n")
            assert s.recv(64).startswith(b"HTTP/1.1 200")
            s.close()
    finally:
        srv.shutdown()
        service.close()


def test_concurrent_clips_share_one_batch(rng, monkeypatch):
    """Three concurrent requests are enhanced as one batch.  The test has
    its own service with a generous window (2 s, as the JAX package's
    test): under parallel test workers the third request can arrive more
    than the shared fixture's 100 ms after the first.  ``max_batch`` rounds
    down to a power of two, so the batch of 4 rows closes when the window
    ends, not at the third request."""
    model = fold_weight_norm(init_weights(instantiate(SERVE_CFG), seed=0)).eval()
    srv, service = make_server(model, model_name="tiny", port=0, max_batch=4,
                               batch_window_ms=2000.0, bucket_seconds=0.1,
                               max_clip_seconds=1.0, enhance_kwargs={"n_steps": 2})
    th = threading.Thread(target=srv.serve_forever, kwargs={"poll_interval": 0.05},
                          daemon=True)
    th.start()
    try:
        _concurrent_clips_share_one_batch(
            f"http://127.0.0.1:{srv.server_address[1]}", rng, monkeypatch)
    finally:
        srv.shutdown()
        service.close()


def _concurrent_clips_share_one_batch(url, rng, monkeypatch):
    t = int(0.05 * FS)
    clips = [0.1 * np.sin(2 * np.pi * f * np.arange(t) / FS)
             + 0.02 * rng.standard_normal(t) for f in (220.0, 330.0, 440.0)]
    calls = []
    real = conv_block.fused_conv_chain_reference
    monkeypatch.setattr(conv_block, "fused_conv_chain_reference",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    before = _stats(url)
    results, go = {}, threading.Barrier(len(clips))

    def post(i):
        body = _wav_bytes(clips[i])
        go.wait()
        results[i] = _post(url, body)

    threads = [threading.Thread(target=post, args=(i,)) for i in range(len(clips))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    for i in range(len(clips)):
        status, body = results[i]
        assert status == 200, body
        out = _decode(body)
        assert out.shape == (1, t) and np.isfinite(out).all() and np.any(out != 0)
    after = _stats(url)
    assert after["clips"] - before["clips"] == 3
    assert after["requests"] - before["requests"] == 3
    assert after["batches"] - before["batches"] == 1  # one window, one batch
    assert after["errors"] == 0 and after["device_realtime_factor"] > 0
    assert calls  # the fused chain ran the batch


def test_stereo_request_equals_direct_enhance(server, rng):
    """Each channel is a row of one batch; the response is model.enhance of
    the bucket-padded batch with the service generator's state."""
    url, service = server
    t = int(0.05 * FS)
    stereo = (0.1 * rng.standard_normal((2, t))).astype(np.float32)
    body = _wav_bytes(stereo)
    state = service.generator.get_state()
    before = _stats(url)
    status, resp = _post(url, body)
    assert status == 200, resp
    out = _decode(resp)
    assert out.shape == (2, t) and not np.array_equal(out[0], out[1])
    assert _stats(url)["clips"] - before["clips"] == 2

    sent, _ = load_audio_bytes(body)
    batch = np.zeros((2, service.quantum), np.float32)  # 0.05 s -> 0.1 s
    batch[:, :t] = sent
    g = torch.Generator(device=service.device)
    g.set_state(state)
    want = service.model.enhance(torch.from_numpy(batch), n_steps=2,
                                 generator=g).numpy()[:, :t]
    np.testing.assert_allclose(out, want, atol=1e-4 + 1.0 / 32767, rtol=0)


def test_flac_request_is_enhanced(server, rng, tmp_path):
    """A FLAC body decodes (the port's codec) and answers 200 with a WAV of
    its rate and channels."""
    url, _ = server
    t = int(0.05 * FS)
    save_audio(tmp_path / "a.flac", (0.1 * rng.standard_normal((2, t))).astype(
        np.float32), FS)
    status, resp = _post(url, (tmp_path / "a.flac").read_bytes())
    assert status == 200, resp
    out = _decode(resp)
    assert out.shape == (2, t) and np.isfinite(out).all()


def load_audio_bytes(body):
    import tempfile

    with tempfile.NamedTemporaryFile(suffix=".wav") as f:
        f.write(body)
        f.flush()
        return load_audio(f.name)


def test_error_statuses(server, rng):
    url, _ = server
    host, port = url.removeprefix("http://").split(":")
    for headers, want in (({}, 411), ({"Content-Length": "x"}, 400),
                          ({"Content-Length": str(10 ** 12)}, 413)):
        conn = http.client.HTTPConnection(host, int(port), timeout=30)
        conn.putrequest("POST", "/enhance")
        for k, v in headers.items():
            conn.putheader(k, v)
        conn.endheaders()
        assert conn.getresponse().status == want
        conn.close()
    too_long = 0.05 * rng.standard_normal(int(1.5 * FS))
    assert _post(url, _wav_bytes(too_long))[0] == 413
    assert _post(url, b"RIFFnot-a-wav-file")[0] == 400
    status, body = _post(url, b"fLaC" + bytes(64))
    assert status == 400 and b"undecodable audio: flac" in body
    assert _stats(url)["errors"] == 0


def test_warmup_grid_leaves_the_sampler_generator_alone():
    model = fold_weight_norm(init_weights(instantiate(SERVE_CFG), seed=1)).eval()
    service = EnhanceService(model, max_batch=3, batch_window_ms=1.0,
                             bucket_seconds=0.02, max_clip_seconds=1.0,
                             enhance_kwargs={"n_steps": 2})
    try:
        assert service.max_batch == 2
        state = service.generator.get_state()
        assert service.precompile(0.02) == 2  # bucket 0.02 s x rows 1, 2
        assert torch.equal(service.generator.get_state(), state)
        job = service.submit(np.zeros(int(0.01 * FS), np.float32))
        assert job.done.wait(timeout=60)
        assert job.error is None and job.result.shape == (int(0.01 * FS),)
        assert service.stats["batches"] == 1
    finally:
        service.close()
    job = service.submit(np.zeros(100, np.float32))
    assert job.done.wait(timeout=5) and job.error is not None


def test_warmup_raises_what_a_shape_raised():
    """A failing shape (a kernel that does not build or launch) fails
    ``precompile`` instead of stopping the worker; the service still
    answers afterwards."""
    model = instantiate(SERVE_CFG)
    service = EnhanceService(model, max_batch=2, batch_window_ms=1.0,
                             bucket_seconds=0.02, enhance_kwargs={"n_steps": 2})
    real = service.enhance

    def enhance(batch, generator):
        if batch.shape[0] == 2:
            raise ValueError("fused_conv_chain has no kernel for C=48")
        return real(batch, generator)

    service.enhance = enhance
    try:
        with pytest.raises(RuntimeError, match="warm-up of 2 x 320") as info:
            service.precompile(0.04)
        assert "C=48" in str(info.value.__cause__)
        assert service._worker.is_alive()
    finally:
        service.close()
