"""PyTorch port: the examples (``headct_foundation_tpu_torch/examples``) on
the CPU. ``extract_feature_sample`` runs the ViT-B/12 extractor on two
scans and a reference ``.pt`` classifier (its probabilities equal the same
classifier applied by hand); ``visualize_attention`` computes the CLS maps
of a tiny extractor on its own phantom, writes the PNG when matplotlib
imports and says it drew nothing when it does not."""

import sys

import numpy as np
import pytest
import torch

from headct_foundation_tpu_torch.bench import synth_scans
from headct_foundation_tpu_torch.examples import extract_feature_sample, visualize_attention
from headct_foundation_tpu_torch.feature_extraction import FeatureExtractor
from headct_foundation_tpu_torch.models.classifier import LinearClassifier


def test_extract_feature_sample(tmp_path, capsys):
    scans = synth_scans(str(tmp_path), 2, shape=(60, 56, 30))
    clf = LinearClassifier(768, 2).init_weights(torch.Generator().manual_seed(3))
    with torch.no_grad():
        clf.bn.running_mean.normal_(generator=torch.Generator().manual_seed(4))
    ckpt = tmp_path / "clf.pt"
    torch.save({"state_dict": {f"module.{k}": v for k, v in clf.state_dict().items()}}, ckpt)
    probs = extract_feature_sample.main([*scans, "--classifier-checkpoint", str(ckpt),
                                         "--device", "cpu"])
    out = capsys.readouterr().out
    assert "last_layer_out: (2, 513, 768)" in out and "12 x (2, 513, 768)" in out
    assert "classifier: 0 missing, 0 unexpected keys" in out
    fe = FeatureExtractor(device="cpu")
    cls = fe(torch.stack([fe.preprocess(p) for p in scans]))[0][:, 0]
    with torch.no_grad():
        want = torch.softmax(clf.eval()(cls).float(), dim=-1).numpy()
    np.testing.assert_allclose(probs, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("matplotlib", [True, False])
def test_visualize_attention(tmp_path, monkeypatch, capsys, matplotlib):
    if matplotlib:
        pytest.importorskip("matplotlib")
    else:
        monkeypatch.setitem(sys.modules, "matplotlib", None)  # an import of it fails
    fe = FeatureExtractor(img_size=24, hidden_size=48, mlp_dim=96, num_layers=2, num_heads=4,
                          device="cpu")
    out = tmp_path / "maps.png"
    maps = visualize_attention.main(["--layers", "0", "1", "--out", str(out)], extractor=fe)
    assert sorted(maps) == [0, 1]
    for m in maps.values():
        assert m.shape == (24, 24, 24) and np.isfinite(m).all() and (m >= 0).all()
    assert out.exists() == matplotlib
    said = capsys.readouterr().out
    assert ("wrote" in said) == matplotlib and ("matplotlib is not installed" in said) != matplotlib
