"""PyTorch port: the embedding server end to end, held against the JAX
package's FeatureExtractor on the same weights.

The port's server runs on the CPU (``device="cpu"``), where the attention
kernel's plain version stands in for the CUDA kernel; the JAX side runs its
Pallas attention interpreted (backend "pallas", ``pallas_min_t`` 1, so the
T=9 blocks reach ``fused_attention``), restored afterwards.
"""

import http.client
import json
import threading

import jax
import numpy as np
import pytest
import torch

from headct_foundation_tpu.feature_extraction import FeatureExtractor as JaxExtractor
from headct_foundation_tpu.ops import attention as jax_attn
from headct_foundation_tpu_torch.data.nifti import save_nifti
from headct_foundation_tpu_torch.feature_extraction import FeatureExtractor
from headct_foundation_tpu_torch.serve_features import MicroBatcher, build_server
from headct_foundation_tpu_torch.utils.torch_interop import state_dict_from_jax

HIDDEN = 48
TINY = dict(img_size=24, patch_size=12, in_chans=3, hidden_size=HIDDEN, mlp_dim=96,
            num_layers=2, num_heads=4)


@pytest.fixture(scope="module")
def extractors():
    """(jax extractor, port extractor) on the same perturbed weights."""
    jfe = JaxExtractor(**TINY)
    rng = np.random.RandomState(0)
    params = jax.tree.map(
        lambda p: (np.asarray(p) + 0.05 * rng.randn(*p.shape)).astype(np.float32), jfe.params)
    jfe.params = jax.tree.map(jax.numpy.asarray, params)
    pfe = FeatureExtractor(device="cpu", **TINY)
    pfe.model.load_state_dict(state_dict_from_jax(params), strict=True)
    return jfe, pfe


def _scan(tmp_path, name="scan.nii.gz"):
    vol = np.full((40, 36, 20), -1000.0, np.float32)
    vol[6:30, 4:28, 2:16] = np.round(
        40.0 + 30.0 * np.random.RandomState(1).randn(24, 24, 14))
    p = str(tmp_path / name)
    save_nifti(p, vol, np.diag([0.5, 0.5, 1.0, 1.0]))
    return p


def test_http_embed_matches_jax_extractor(extractors, tmp_path):
    """POST /embed of a gzipped NIfTI returns the JAX pipeline's embedding;
    bad requests get 400/500 and the server keeps serving."""
    jfe, pfe = extractors
    path = _scan(tmp_path)
    prev = (jax_attn.set_attention_backend("pallas"), jax_attn.set_pallas_min_t(1))
    try:
        want = jfe.cls_embedding(np.asarray(jfe.preprocess(path))[None])[0]
    finally:
        jax_attn.set_attention_backend(prev[0])
        jax_attn.set_pallas_min_t(prev[1])

    server, batcher = build_server(pfe, host="127.0.0.1", port=0, max_batch=2, window_ms=2.0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with open(path, "rb") as f:
            blob = f.read()
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=120)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        assert health["ok"] and health["hidden"] == HIDDEN and health["device"] == "cpu"

        conn.request("POST", "/embed", body=blob)
        resp = conn.getresponse()
        assert resp.status == 200
        out = json.loads(resp.read())
        assert len(out["embedding"]) == HIDDEN and out["batched_with"] == 1
        np.testing.assert_allclose(out["embedding"], want, atol=1e-4, rtol=1e-4)

        conn.request("POST", "/embed", body=b"")
        resp = conn.getresponse()
        resp.read()  # keep-alive: drain before reusing the connection
        assert resp.status == 400
        conn.request("POST", "/embed", body=b"not a nifti at all")
        resp = conn.getresponse()
        assert resp.status == 500
        assert "error" in json.loads(resp.read())
        conn.request("GET", "/healthz")
        assert json.loads(conn.getresponse().read())["ok"]
        conn.close()
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()
        thread.join(timeout=30)
    assert not thread.is_alive()


def test_microbatcher_coalesces_and_matches_unbatched(extractors):
    """Concurrent submits share forwards, and batched embeddings equal the
    unbatched ones."""
    _, pfe = extractors
    batcher = MicroBatcher(pfe, max_batch=4, window_ms=150.0)
    try:
        vols = [torch.from_numpy(np.random.RandomState(i).rand(3, 24, 24, 24).astype(np.float32))
                for i in range(4)]
        results = [None] * 4

        def hit(i):
            results[i] = batcher.submit(vols[i])

        threads = [threading.Thread(target=hit, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        assert batcher.requests == 4
        assert batcher.batches < 4, (batcher.batches, batcher.requests)
        for i, (emb, batched_with) in enumerate(results):
            assert emb.shape == (HIDDEN,) and 1 <= batched_with <= 4
            np.testing.assert_allclose(emb, pfe.cls_embedding(vols[i])[0], rtol=2e-5, atol=2e-5)
    finally:
        batcher.close()


def test_extract_from_files_keeps_order(extractors, tmp_path):
    _, pfe = extractors
    paths = [_scan(tmp_path, f"s{i}.nii.gz") for i in range(3)]
    feats = pfe.extract_from_files(paths, batch_size=2, workers=2)
    assert feats.shape == (3, HIDDEN)
    np.testing.assert_allclose(feats[2], pfe.cls_embedding(pfe.preprocess(paths[2]))[0],
                               rtol=2e-5, atol=2e-5)
    assert pfe.extract_from_files([]).shape == (0, HIDDEN)
    assert pfe.token_grid == (2, 2, 2)
