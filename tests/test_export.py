"""AOT serving-artifact export (mv3d_tpu/serving): round-trip bit-exactness,
single-frame convenience API, quantized signature, cross-platform lowering,
and the CLI entry point. The reference has no serialized serving artifact —
deployment re-runs the graph-building source (reference mv3d.py:666-691) —
so this surface is beyond-reference; the tests pin its contract."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_model import CFG

from mv3d_tpu.serving import build_serving_fn, export_serving, load_serving


def _inputs(b=1, seed=0):
    rng = np.random.RandomState(seed)
    n = CFG.pipeline.max_points
    pts = np.stack([rng.uniform(0, 16, (b, n)), rng.uniform(-6, 6, (b, n)),
                    rng.uniform(-4, 0.8, (b, n)), rng.uniform(0, 1, (b, n))],
                   axis=-1).astype(np.float32)
    num = np.full((b,), n, np.int32)
    rgb = rng.rand(b, *CFG.rgb_shape).astype(np.float32)
    return pts, num, rgb


@pytest.fixture(scope="module")
def variables():
    from mv3d_tpu.models import MV3DNet
    model = MV3DNet(CFG)
    return model.init_variables(jax.random.PRNGKey(0))


def test_export_roundtrip_bitexact(variables, tmp_path):
    """serialize -> deserialize -> run == direct jit run, bit for bit."""
    out = export_serving(variables, CFG, str(tmp_path / "art"), batch_size=2,
                         score_threshold=0.05)
    served = load_serving(out)

    pts, num, rgb = _inputs(b=2)
    got_boxes, got_probs, got_mask = served(pts, num, rgb)

    fn, _ = build_serving_fn(CFG, score_threshold=0.05)
    want = jax.jit(fn)(variables, jnp.asarray(pts), jnp.asarray(num),
                       jnp.asarray(rgb))
    np.testing.assert_array_equal(got_boxes, np.asarray(want[0]))
    np.testing.assert_array_equal(got_probs, np.asarray(want[1]))
    np.testing.assert_array_equal(got_mask, np.asarray(want[2]))

    meta = json.loads((tmp_path / "art" / "meta.json").read_text())
    assert meta["batch_size"] == 2 and not meta["quantized"]
    assert meta["input_names"] == ["points", "num_points", "rgb"]


def test_artifact_needs_no_flatbuffers(variables, tmp_path, monkeypatch):
    """Serving hosts may lack the optional package jax.export's own
    serializer needs: exporting and loading an artifact never imports it,
    and the rebuilt program has the exporter's signature."""
    import sys
    monkeypatch.setitem(sys.modules, "flatbuffers", None)   # import fails
    monkeypatch.delitem(sys.modules, "jax._src.export.serialization",
                        raising=False)
    out = export_serving(variables, CFG, str(tmp_path / "art"), batch_size=1,
                         score_threshold=0.05)
    served = load_serving(out)
    fn, specs = build_serving_fn(CFG, score_threshold=0.05)
    want = jax.export.export(jax.jit(fn))(
        jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                     variables), *specs(1))
    assert served.exported.in_tree == want.in_tree
    assert served.exported.in_avals == want.in_avals
    assert served.exported.out_avals == want.out_avals
    pts, num, rgb = _inputs(b=1, seed=5)
    boxes, probs, mask = served(pts, num, rgb)
    assert np.isfinite(boxes).all() and mask.dtype == bool


def test_export_predict_single_frame(variables, tmp_path):
    """predict() pads a ragged cloud to the frozen bucket and filters by the
    detection mask."""
    out = export_serving(variables, CFG, str(tmp_path / "art1"), batch_size=1)
    served = load_serving(out)
    pts, _, rgb = _inputs(b=1, seed=1)
    ragged = np.asarray(pts[0][: CFG.pipeline.max_points // 2])
    boxes3d, probs = served.predict(ragged, rgb[0])
    assert boxes3d.ndim == 3 and boxes3d.shape[1:] == (8, 3)
    assert probs.shape == (boxes3d.shape[0],)
    assert np.isfinite(boxes3d).all()


def test_export_quantized_signature(variables, tmp_path):
    """The quantized artifact consumes the uint16/uint8 transfer diet and
    matches the in-process quantized pipeline bit-exactly; predict()
    quantizes host-side from the grid bounds carried in meta.json (no cfg
    on the serving host)."""
    from mv3d_tpu.ops.quantize import _bounds, quantize_points

    out = export_serving(variables, CFG, str(tmp_path / "artq"), batch_size=1,
                         quantized=True)
    served = load_serving(out)
    pts, num, rgb = _inputs(b=1, seed=2)
    q, r = quantize_points(pts, CFG)
    got = served(q, r, num, rgb)

    fn, _ = build_serving_fn(CFG, quantized=True)
    want = jax.jit(fn)(variables, jnp.asarray(q), jnp.asarray(r),
                       jnp.asarray(num), jnp.asarray(rgb))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))

    lo, hi = _bounds(CFG)
    assert served.meta["quant_bounds"] == {"lo": lo.tolist(),
                                           "hi": hi.tolist()}
    boxes3d, probs = served.predict(pts[0], rgb[0])
    assert boxes3d.shape[1:] == (8, 3) and np.isfinite(boxes3d).all()
    # meta-driven host quantization == cfg-driven: same detections
    keep = got[2][0].astype(bool)
    np.testing.assert_array_equal(boxes3d, got[0][0][keep])


def test_export_cross_platform_lowering(variables, tmp_path):
    """A CPU-only build host can emit a GPU+CPU artifact (cross-platform
    lowering; nothing executes at export time) and the loaded artifact still
    runs on the CPU branch."""
    out = export_serving(variables, CFG, str(tmp_path / "artx"), batch_size=1,
                         platforms=("cuda", "cpu"))
    served = load_serving(out)
    assert set(served.meta["platforms"]) == {"cuda", "cpu"}
    pts, num, rgb = _inputs(b=1, seed=3)
    boxes, probs, mask = served(pts, num, rgb)
    assert np.isfinite(boxes).all() and mask.dtype == bool


def test_cli_export_random_init(tmp_path):
    """python -m mv3d_tpu.cli.export --random-init on the tiny config."""
    from mv3d_tpu.cli.export import main

    overrides = tmp_path / "tiny.json"
    from test_cli_mains import TINY_OVERRIDES
    overrides.write_text(json.dumps(TINY_OVERRIDES))
    out = main(["--random-init", "--out", str(tmp_path / "cli_art"),
                "--config", str(overrides),
                "--checkpoint-dir", str(tmp_path / "ckpt")])
    served = load_serving(out)
    pts, num, rgb = _inputs(b=1, seed=4)
    boxes, probs, mask = served(pts, num, rgb)
    assert boxes.shape[0] == 1


def test_export_int8_model(variables, tmp_path):
    """model.quant='int8' exports: the artifact carries the int8 serving
    program (weights quantize in-graph from the float params riding in the
    artifact) and matches the in-process quantized-model pipeline."""
    import dataclasses

    qcfg = dataclasses.replace(
        CFG, model=dataclasses.replace(CFG.model, quant="int8"))
    out = export_serving(variables, qcfg, str(tmp_path / "arti8"),
                         batch_size=1, score_threshold=0.05)
    served = load_serving(out)
    pts, num, rgb = _inputs(b=1, seed=5)
    got = served(pts, num, rgb)
    assert np.isfinite(got[0]).all() and np.isfinite(got[1]).all()

    fn, _ = build_serving_fn(qcfg, score_threshold=0.05)
    want = jax.jit(fn)(variables, jnp.asarray(pts), jnp.asarray(num),
                       jnp.asarray(rgb))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_serve_http_endpoint(variables, tmp_path):
    """cli/serve: the exported artifact answers over plain HTTP — healthz
    returns the artifact meta, and POST /predict (npz body) matches the
    in-process predict() exactly (npz and JSON responses)."""
    import io
    import threading
    import urllib.request

    from mv3d_tpu.cli.serve import make_server

    out = export_serving(variables, CFG, str(tmp_path / "art"), batch_size=1,
                         score_threshold=0.0)
    srv = make_server(out, port=0)
    port = srv.server_address[1]
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
            meta = json.loads(r.read())
        assert meta["status"] == "ok" and meta["batch_size"] == 1

        pts, _, rgb = _inputs(b=1)
        served = load_serving(out)
        want_boxes, want_probs = served.predict(pts[0], rgb[0])

        buf = io.BytesIO()
        np.savez_compressed(buf, points=pts[0], rgb=rgb[0])
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/predict", data=buf.getvalue(),
            method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            with np.load(io.BytesIO(r.read())) as z:
                np.testing.assert_array_equal(z["boxes3d"], want_boxes)
                np.testing.assert_array_equal(z["probs"], want_probs)

        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/predict", data=buf.getvalue(),
            method="POST", headers={"Accept": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            got = json.loads(r.read())
        np.testing.assert_allclose(np.asarray(got["boxes3d"], np.float32),
                                   want_boxes, rtol=1e-6)

        # malformed body -> 400 with a cause, not a hung socket
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/predict", data=b"not-an-npz",
            method="POST")
        try:
            urllib.request.urlopen(req, timeout=30)
            assert False, "expected HTTP 400"
        except urllib.error.HTTPError as e:
            assert e.code == 400 and "error" in json.loads(e.read())
    finally:
        srv.shutdown()


def test_serve_batched_artifact_and_concurrency(variables, tmp_path):
    """VERDICT r4 #8: batch>1 artifacts serve single-frame AND stacked
    requests (predict_batch pads to the frozen batch with empty frames),
    and the endpoint survives concurrent clients — identical inputs get
    identical answers under contention."""
    import io
    import threading
    import urllib.request

    from mv3d_tpu.cli.serve import make_server

    out = export_serving(variables, CFG, str(tmp_path / "artb"),
                         batch_size=2, score_threshold=0.0)
    served = load_serving(out)
    pts, _, rgb = _inputs(b=2, seed=3)

    # predict() works on a batch-2 artifact (pads with an empty frame)
    b0, p0 = served.predict(pts[0], rgb[0])
    assert b0.shape[1:] == (8, 3) and b0.shape[0] == p0.shape[0]

    # predict_batch: 2 frames in one execution, per-frame results match
    # the padded single-frame path
    both = served.predict_batch([(pts[0], rgb[0]), (pts[1], rgb[1])])
    assert len(both) == 2
    np.testing.assert_array_equal(both[0][0], b0)
    with pytest.raises(ValueError, match="batch"):
        served.predict_batch([(pts[0], rgb[0])] * 3)

    srv = make_server(out, port=0)
    port = srv.server_address[1]
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        # stacked request form: points_i/rgb_i in, boxes3d_i/probs_i out
        buf = io.BytesIO()
        np.savez_compressed(buf, points_0=pts[0], rgb_0=rgb[0],
                            points_1=pts[1], rgb_1=rgb[1])
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/predict", data=buf.getvalue(),
            method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            with np.load(io.BytesIO(r.read())) as z:
                np.testing.assert_array_equal(z["boxes3d_0"], both[0][0])
                np.testing.assert_array_equal(z["boxes3d_1"], both[1][0])
                np.testing.assert_array_equal(z["probs_1"], both[1][1])

        # concurrent single-frame clients: all succeed, all identical
        single = io.BytesIO()
        np.savez_compressed(single, points=pts[0], rgb=rgb[0])
        body = single.getvalue()
        results, errors = [None] * 6, []

        def client(i):
            try:
                rq = urllib.request.Request(
                    f"http://127.0.0.1:{port}/predict", data=body,
                    method="POST")
                with urllib.request.urlopen(rq, timeout=180) as resp:
                    with np.load(io.BytesIO(resp.read())) as z:
                        results[i] = (z["boxes3d"], z["probs"])
            except Exception as e:  # noqa: BLE001 — collected for assert
                errors.append(repr(e))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not errors, errors
        for bx, pr in results:
            np.testing.assert_array_equal(bx, b0)
            np.testing.assert_array_equal(pr, p0)
    finally:
        srv.shutdown()
