"""The user scripts of ``examples/`` on the port (``repro_torch.examples``),
each run in-process on the CPU at tiny settings: the lines they print and
the dict ``main`` returns. Quickstart reads freshly drawn CNN weights from a
temporary npz file (``--params``), so nothing is trained and nothing under
``results/`` is read or written.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import PAPER_CNN
from repro_torch.examples import explain_serving, quickstart, serve_lm, train_lm
from repro_torch.models import cnn
from repro_torch.train.classifier import save_params

torch.set_num_threads(1)


def test_quickstart(tmp_path, capsys):
    path = tmp_path / "cnn.npz"
    save_params(path, cnn.init_params(PAPER_CNN, torch.Generator().manual_seed(0), device="cpu"))
    out = quickstart.main(["--device", "cpu", "--params", str(path)])
    text = capsys.readouterr().out
    assert "method=uniform  m=32 convergence delta=" in text and "method=paper    m=32" in text
    assert f"NUIG attribution heatmap (target class {out['target']})" in text
    assert set(out["delta"]) == {"uniform", "paper"} and all(np.isfinite(v) for v in out["delta"].values())
    rows = out["heatmap"].split("\n")
    assert len(rows) == 32 and all(len(r) == 32 for r in rows) and out["heatmap"] in text
    assert 1 <= out["target"] <= 9


def test_ascii_heatmap_shades_the_largest_magnitude():
    heat = quickstart.ascii_heatmap(np.array([[0.0, -2.0], [1.0, 0.5]]))
    assert heat == " %\n=:"  # the largest falls just short of "@": |a| / (max + 1e-12)


def test_explain_serving(capsys):
    out = explain_serving.main(["--device", "cpu", "--requests", "2", "--seq", "8", "--m", "8"])
    text = capsys.readouterr().out
    for line in ("method=paper    m=8 batch=2", "method=uniform  m=8 batch=2", "uniform m=8: delta=",
                 "top-5 attributed positions (request 0):", "-- adaptive: tol=0.01 relative δ, ladder from m=4",
                 "request 1: m_used=", "adaptive wall="):
        assert line in text, line
    assert set(out["methods"]) == {"paper", "uniform"}
    assert list(out["iso"])[0] == 8 and set(out["iso"]) <= {8, 16, 32, 64}
    assert out["iso_factor"] is None or out["iso_factor"] == max(out["iso"]) / 8
    assert len(out["top5"]) == 5 and all(0 <= p < 8 for p in out["top5"])
    ad = out["adaptive"]
    assert len(ad["requests"]) == 2 and ad["steps"] >= 2 * 4
    assert all(r["m_used"] in (4, 8, 16) for r in ad["requests"])


@pytest.mark.parametrize("arch", ["llama3-8b", "internvl2-26b"])
def test_serve_lm(arch, capsys):
    out = serve_lm.main(["--device", "cpu", "--arch", arch, "--batch", "2", "--tokens", "4"])
    text = capsys.readouterr().out
    assert f"arch={arch}-reduced: generated (2, 4) in" in text and "tok/s incl. prefill" in text
    assert "sample:" in text
    assert out["shape"] == (2, 4) and len(out["sample"]) == 4 and out["arch"] == f"{arch}-reduced"


def test_train_lm(tmp_path, capsys):
    out = train_lm.main(["--device", "cpu", "--steps", "4", "--batch", "4", "--seq", "32",
                         "--ckpt-dir", str(tmp_path)])
    text = capsys.readouterr().out
    assert "model: llama-10m  params=" in text and "steps=4" in text
    assert "done: 4 steps" in text and "stragglers=" in text
    assert out["steps"] == 4 and len(out["losses"]) == 4 and out["losses"][-1] < out["losses"][0]
    assert train_lm.SIZES["100m"]["d_model"] == 768


@pytest.mark.parametrize("module", [quickstart, explain_serving, serve_lm, train_lm])
def test_the_card_or_an_exit(module):
    """``--device cuda`` (the default) without a card exits non-zero; it
    never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit) as e:
        module.main([])
    assert e.value.code not in (0, None)
