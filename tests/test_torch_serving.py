"""The PyTorch port's serving path on the CPU: input preparation and the
Predictor against the JAX package, and the coalescing server and HTTP
front end re-run from ``tests/test_serve.py``."""

import io
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focused_attention_vit_tpu_torch import serve as tserve
from focused_attention_vit_tpu_torch.convert.from_jax import (
    flax_vit_mhla_to_state_dict,
)
from focused_attention_vit_tpu_torch.data.pipeline import prepare_eval_batch
from focused_attention_vit_tpu_torch.infer import Predictor
from focused_attention_vit_tpu_torch.models import VisionTransformerMHLA
from focused_attention_vit_tpu_torch.serve import BatchingServer, HTTPFrontend

torch.set_num_threads(2)

GEOM = dict(img_size=32, patch_size=8, num_classes=10, embed_dim=32,
            depth=1, num_heads=2, window_size=7)


@pytest.fixture(scope="module")
def predictor():
    model = VisionTransformerMHLA(**GEOM,
                                  generator=torch.Generator().manual_seed(0))
    p = Predictor(model, img_size=32, device="cpu", batch_size=8,
                  compute_dtype=torch.float32)
    p.warmup()
    return p


def _images(rng, n, hw=32):
    return rng.integers(0, 255, size=(n, hw, hw, 3)).astype(np.uint8)


@pytest.mark.parametrize("src,dst", [(32, 224), (20, 32), (32, 32)])
def test_prepare_eval_batch_matches_jax(src, dst):
    from focused_attention_vit_tpu.data.pipeline import (
        prepare_eval_batch as jax_prepare_eval_batch,
    )

    imgs = _images(np.random.default_rng(src), 3, src)
    got = prepare_eval_batch(torch.from_numpy(imgs), dst).numpy()
    want = np.asarray(jax_prepare_eval_batch(jnp.asarray(imgs), dst))
    assert got.shape == (3, dst, dst, 3)
    # f32 bilinear weights computed in different orders (7e-7 seen).
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)


@pytest.mark.parametrize("img_size,hw", [(32, 20), (96, 96)])
def test_predictor_matches_jax_predictor(img_size, hw):
    """Port and JAX Predictor at compute_dtype=float32 on one set of
    weights; 96 with patch 4 is S=577, the band op's branch."""
    from focused_attention_vit_tpu.infer import Predictor as JaxPredictor
    from focused_attention_vit_tpu.models import (
        VisionTransformerMHLA as JaxVisionTransformerMHLA,
    )

    geom = dict(GEOM, img_size=img_size, patch_size=4)
    jmodel = JaxVisionTransformerMHLA(use_mhla=True, **geom)
    params = jmodel.init(jax.random.PRNGKey(1),
                         jnp.zeros((1, img_size, img_size, 3)))["params"]
    jpred = JaxPredictor(jmodel, params, img_size=img_size, batch_size=4,
                         compute_dtype=jnp.float32)
    tmodel = VisionTransformerMHLA(**geom)
    tmodel.load_state_dict(flax_vit_mhla_to_state_dict(params))
    tpred = Predictor(tmodel, img_size=img_size, device="cpu", batch_size=4,
                      compute_dtype=torch.float32)
    imgs = _images(np.random.default_rng(img_size), 6, hw)
    got = tpred.predict_proba(imgs)
    assert got.shape == (6, 10) and got.dtype == np.float32
    np.testing.assert_allclose(got, jpred.predict_proba(imgs), atol=1e-5)
    ids, top = tpred.predict(imgs)
    np.testing.assert_array_equal(ids, got.argmax(-1))
    np.testing.assert_allclose(top, got.max(-1))


@pytest.mark.parametrize("img_size", [12, 32, 96])
def test_predictor_bf16_close_to_f32(img_size):
    """The bf16 serving path (gather, dense band, band op's plain version)
    against f32 on the same weights: bf16 rounds each activation to about
    2^-8 relative, so 2e-3 on near-uniform probabilities (3e-4 seen)."""
    imgs = _images(np.random.default_rng(img_size), 5)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        model = VisionTransformerMHLA(**dict(GEOM, img_size=img_size,
                                             patch_size=4, depth=2))
        out[dtype] = Predictor(model, img_size=img_size, device="cpu",
                               batch_size=4,
                               compute_dtype=dtype).predict_proba(imgs)
    assert out[torch.bfloat16].dtype == np.float32
    assert np.isfinite(out[torch.bfloat16]).all()
    np.testing.assert_allclose(out[torch.bfloat16], out[torch.float32],
                               atol=2e-3, rtol=0)


class TestBatchingServer:
    def test_results_match_direct_predictor(self, predictor):
        rng = np.random.default_rng(1)
        reqs = [_images(rng, n) for n in (1, 3, 2, 4, 6, 8)]
        with BatchingServer(predictor, max_delay_ms=100.0) as srv:
            futs = [srv.submit(r) for r in reqs]
            outs = [f.result(timeout=30) for f in futs]
        for req, out in zip(reqs, outs):
            assert out.shape == (len(req), 10)
            np.testing.assert_allclose(out, predictor.predict_proba(req),
                                       rtol=0, atol=1e-6)

    def test_coalesces_into_full_batches(self, predictor):
        rng = np.random.default_rng(2)
        srv = BatchingServer(predictor, max_delay_ms=250.0)
        try:
            futs = [srv.submit(_images(rng, 2)) for _ in range(4)]
            for f in futs:
                f.result(timeout=30)
            assert srv.stats.batches == 1
            assert srv.stats.batched_images == 8
            assert srv.stats.mean_batch_fill == pytest.approx(1.0)
            assert srv.stats.requests == 4
        finally:
            srv.close()

    def test_oversize_request_ships_alone(self, predictor):
        req = _images(np.random.default_rng(3), 20)
        with BatchingServer(predictor, max_delay_ms=10.0) as srv:
            out = srv.predict_proba(req)
            assert srv.stats.oversize_requests == 1
        assert out.shape == (20, 10)
        np.testing.assert_allclose(out, predictor.predict_proba(req),
                                   rtol=0, atol=1e-6)

    def test_concurrent_submitters_and_mixed_shapes(self, predictor):
        rng = np.random.default_rng(4)
        reqs = [_images(rng, 1 + (i % 5), 32 if i % 3 else 48)
                for i in range(12)]
        outs = [None] * len(reqs)
        with BatchingServer(predictor, max_delay_ms=20.0) as srv:

            def client(i):
                outs[i] = srv.submit(reqs[i]).result(timeout=60)

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(len(reqs))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
                assert not t.is_alive()
        for req, out in zip(reqs, outs):
            np.testing.assert_allclose(out, predictor.predict_proba(req),
                                       rtol=0, atol=1e-6)

    def test_empty_request_rejected(self, predictor):
        with BatchingServer(predictor, max_delay_ms=5.0) as srv:
            with pytest.raises(ValueError, match="non-empty"):
                srv.submit(np.zeros((0, 32, 32, 3), np.uint8))

    def test_cancelled_future_does_not_kill_worker(self, predictor):
        rng = np.random.default_rng(8)
        with BatchingServer(predictor, max_delay_ms=200.0) as srv:
            f1 = srv.submit(_images(rng, 2))
            f1.cancel()
            assert srv.submit(_images(rng, 2)).result(timeout=60).shape == (
                2, 10)

    def test_submit_after_close_raises(self, predictor):
        srv = BatchingServer(predictor, max_delay_ms=1.0)
        srv.close()
        with pytest.raises(RuntimeError, match="closed"):
            srv.submit(np.zeros((1, 32, 32, 3), np.uint8))

    def test_close_drains_pending(self, predictor):
        srv = BatchingServer(predictor, max_delay_ms=5000.0)
        fut = srv.submit(_images(np.random.default_rng(5), 3))
        srv.close()  # cuts the delay short and still serves the request
        assert fut.result(timeout=30).shape == (3, 10)

    def test_close_with_hung_worker_fails_queued_and_inflight(self):
        release = threading.Event()

        class _Hung:
            batch_size = 4

            def predict_proba(self, images_u8):
                release.wait()
                return np.zeros((len(images_u8), 10), np.float32)

        rng = np.random.default_rng(6)
        srv = BatchingServer(_Hung(), max_delay_ms=1.0)
        f1 = srv.submit(_images(rng, 1))
        time.sleep(0.3)
        f2 = srv.submit(_images(rng, 1))
        srv.close(timeout=0.5)
        for f in (f1, f2):
            with pytest.raises(RuntimeError, match="unresponsive"):
                f.result(timeout=10)
        release.set()

    def test_two_batches_in_flight_concurrently(self):
        barrier = threading.Barrier(2, timeout=15)

        class _Rendezvous:
            batch_size = 2

            def predict_proba(self, images_u8):
                barrier.wait()  # only returns with two batches inside
                return np.zeros((len(images_u8), 10), np.float32)

        rng = np.random.default_rng(9)
        srv = BatchingServer(_Rendezvous(), max_delay_ms=1.0, workers=2)
        try:
            f1 = srv.submit(_images(rng, 2))
            f2 = srv.submit(_images(rng, 2))
            assert f1.result(timeout=30).shape == (2, 10)
            assert f2.result(timeout=30).shape == (2, 10)
        finally:
            srv.close()


class TestHTTPFrontend:
    def _post(self, url, body: bytes):
        req = urllib.request.Request(url + "/predict", data=body,
                                     method="POST")
        return urllib.request.urlopen(req, timeout=60)

    @staticmethod
    def _npy(arr):
        buf = io.BytesIO()
        np.save(buf, arr)
        return buf.getvalue()

    def test_predict_healthz_stats(self, predictor):
        rng = np.random.default_rng(6)
        reqs = [_images(rng, n) for n in (2, 5, 8)]
        with BatchingServer(predictor, max_delay_ms=5.0) as srv:
            with HTTPFrontend(srv, port=0) as fe:
                url = f"http://{fe.host}:{fe.port}"
                with urllib.request.urlopen(url + "/healthz", timeout=10) as r:
                    assert r.read() == b"ok"
                for req in reqs:
                    with self._post(url, self._npy(req)) as resp:
                        assert resp.status == 200
                        out = np.load(io.BytesIO(resp.read()))
                    np.testing.assert_allclose(
                        out, predictor.predict_proba(req), atol=1e-6)
                with urllib.request.urlopen(url + "/stats", timeout=10) as r:
                    stats = json.loads(r.read())
        assert stats["requests"] == 3
        assert stats["images"] == 15

    @pytest.mark.parametrize("body", [b"not an npy", "3d"])
    def test_bad_request_is_400(self, predictor, body):
        if body == "3d":
            body = self._npy(np.zeros((32, 32, 3), np.uint8))
        with BatchingServer(predictor, max_delay_ms=5.0) as srv:
            with HTTPFrontend(srv, port=0) as fe:
                with pytest.raises(urllib.error.HTTPError) as ei:
                    self._post(f"http://{fe.host}:{fe.port}", body)
                assert ei.value.code == 400

    def test_server_fault_is_503(self, predictor):
        with BatchingServer(predictor, max_delay_ms=5.0) as srv:
            with HTTPFrontend(srv, port=0) as fe:
                srv.close()
                with pytest.raises(urllib.error.HTTPError) as ei:
                    self._post(f"http://{fe.host}:{fe.port}",
                               self._npy(np.zeros((1, 32, 32, 3), np.uint8)))
                assert ei.value.code == 503


def test_setup_builds_a_predictor_from_argv(tmp_path):
    model = VisionTransformerMHLA(**GEOM,
                                  generator=torch.Generator().manual_seed(2))
    path = tmp_path / "w.pt"
    torch.save(model.state_dict(), path)
    args, pred = tserve.setup([
        "--weights", str(path), "--img_size", "32", "--patch_size", "8",
        "--embed_dim", "32", "--depth", "1", "--num_heads", "2",
        "--compute_dtype", "float32", "--batch_size", "4", "--device", "cpu",
    ])
    assert args.batch_size == 4 and pred.batch_size == 4
    imgs = _images(np.random.default_rng(0), 5)
    with torch.inference_mode():
        want = torch.softmax(
            model(prepare_eval_batch(torch.from_numpy(imgs), 32)), -1)
    np.testing.assert_allclose(pred.predict_proba(imgs), want.numpy(),
                               atol=1e-6)


def test_weights_or_checkpoint_dir_exactly_one(capsys):
    """``--checkpoint_dir`` was rejected until checkpointing was ported
    (tests/test_torch_checkpoint.py serves from one); now exactly one of it
    and ``--weights`` is required."""
    p = tserve._parser()
    assert p.parse_args(["--checkpoint_dir", "d"]).checkpoint_dir == "d"
    for argv in ([], ["--weights", "w.pt", "--checkpoint_dir", "d"]):
        with pytest.raises(SystemExit):
            p.parse_args(argv)


@pytest.mark.parametrize("flag", [
    ["--from_export", "x"],
    ["--export_artifact", "x", "--from_export", "y"], ["--num_devices", "2"],
    ["--tp", "2"], ["--model", "sppp"],
])
def test_flags_outside_the_slice_are_rejected(flag, capsys):
    """The export flags have been ported since (tests/test_torch_export.py):
    beside ``--weights``, ``--from_export`` is refused as exclusive, and
    ``--export_artifact`` is refused beside ``--from_export``. The mesh
    flags have been ported since (tests/test_torch_sequence_pipeline.py
    serves on two ranks): ``--num_devices 2`` and ``--tp 2`` are taken and
    ask for two ranks, as JAX's rule says, on the CPU too."""
    if flag[0] in ("--num_devices", "--tp"):
        args = tserve._parser().parse_args(
            ["--weights", "w.pt", "--device", "cpu", *flag])
        assert getattr(args, flag[0][2:]) == 2
        # --tp alone takes every device: one on the CPU.
        want = 2 if flag[0] == "--num_devices" else 1
        assert tserve._world_size(args) == want
        return
    with pytest.raises(SystemExit):
        tserve._parser().parse_args(["--weights", "w.pt", *flag])
