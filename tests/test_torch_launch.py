"""The port's launchers against ``repro``'s, on the CPU.

Each case runs ``repro``'s ``main`` (``sys.argv`` monkeypatched) and the
port's ``main([..., "--device", "cpu"])`` with ``repro``'s seeded draws
substituted for the port's ``draw`` (weights through
``params_from_numpy``, the ViT's image, the serve path's prompts and
frontend features), then parses both outputs. ``get_config`` is wrapped in
both CLI modules to return the config at ``compute_dtype="float32"`` (no
file of ``repro`` changes). Arguments are small: ``--m 8 --requests 4
--rounds 2 --max-seq 20`` on the reduced configs.

What must agree: every leg's header line, its buckets (B, S, calls,
requests), its hits and misses, per round the mean and max δ within one
unit of the printed fifth decimal (values that differ in the sixth may
round apart); the ``--workload prompt``
table's scores within 1e-4 of the largest |score|, and the top-5 positions
(or patches) equal except where two scores lie within that tolerance of
each other; classic serving's printed greedy ids equal (internvl2's only at
the steps before ``repro``'s clamped cache writes: the port sizes its cache
with the patches); mixed serving's done counts equal.
"""
import dataclasses
import re
import sys

import jax
import numpy as np
import pytest
import torch

import repro.launch.explain as j_explain
import repro.launch.serve as j_serve
from repro.configs import ArchConfig as JArchConfig, LayerSpec as JLayerSpec, get_config as j_get_config
from repro.configs.vit import reduced_vit as j_reduced_vit
from repro.models import vit as jvit
from repro.models.registry import Model as JModel
from repro_torch.configs import get_config, reduced
from repro_torch.configs.vit import VitConfig
from repro_torch.launch import explain, serve, sized
from repro_torch.models import lm, vit as tvit

torch.set_num_threads(1)

SMALL = ["--m", "8", "--requests", "4", "--rounds", "2", "--max-seq", "20"]
DELTA_TOL = 1.1e-5  # one unit of the 5-decimal print: two values 1e-6 apart may round apart
SCORE_TOL = 1e-4  # of the largest |score|


@pytest.fixture
def f32(monkeypatch):
    """Both CLIs resolve configs at f32 compute."""
    monkeypatch.setattr(j_explain, "get_config", lambda n: dataclasses.replace(j_get_config(n),
                                                                               compute_dtype="float32"))
    monkeypatch.setattr(j_serve, "get_config", lambda n: dataclasses.replace(j_get_config(n),
                                                                             compute_dtype="float32"))
    for mod in (explain, serve):
        monkeypatch.setattr(mod, "get_config", lambda n: dataclasses.replace(get_config(n),
                                                                             compute_dtype="float32"))
    monkeypatch.setattr(explain, "draw", _repro_explain_draw)
    monkeypatch.setattr(serve, "draw", _repro_serve_draw)


def _repro_config(cfg) -> JArchConfig:
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["pattern"] = tuple(JLayerSpec(s.mixer, s.ffn) for s in cfg.pattern)
    return JArchConfig(**fields)


def _repro_params(cfg, seed, device):
    return lm.params_from_numpy(JModel(_repro_config(cfg)).init(jax.random.PRNGKey(seed)), device=device)


def _repro_explain_draw(cfg, seed, device="cuda"):
    """``repro.launch.explain``'s draws: ``Model.init(PRNGKey(seed))``; for
    the ViT ``vit.init`` and a uniform image from PRNGKey(seed + 1)."""
    if isinstance(cfg, VitConfig):
        jcfg = j_reduced_vit()
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
        img = jax.random.uniform(jax.random.PRNGKey(seed + 1),
                                 (1, jcfg.image_size, jcfg.image_size, jcfg.channels))
        return (tvit.params_from_numpy(jvit.init(jcfg, jax.random.PRNGKey(seed)), device=device),
                torch.from_numpy(np.asarray(img)).to(device))
    return _repro_params(cfg, seed, device), None


def _repro_serve_draw(cfg, args, device="cuda"):
    """``repro.launch.serve``'s draws: the weights, prompt ids from
    PRNGKey(seed + 1) and frontend features of ones."""
    toks = jax.random.randint(jax.random.PRNGKey(args.seed + 1), (args.batch, args.prompt_len), 0,
                              cfg.vocab_size)
    batch = {"tokens": torch.from_numpy(np.asarray(toks)).to(device)}
    if cfg.frontend:
        n = cfg.frontend_tokens if cfg.frontend == "vision" else cfg.encoder_seq
        batch["frontend"] = torch.ones((args.batch, n, cfg.frontend_dim), device=device)
    return _repro_params(cfg, args.seed, device), batch


def _both(capsys, monkeypatch, jmod, tmod, argv):
    """(repro's output, the port's output, what the port's ``run``
    returned)."""
    monkeypatch.setattr(sys, "argv", ["launch"] + argv)
    assert jmod.main() == 0
    want = capsys.readouterr().out
    real, returned = tmod.run, []
    monkeypatch.setattr(tmod, "run", lambda args: returned.append(real(args)))
    assert tmod.main(argv + ["--device", "cpu"]) == 0
    return want, capsys.readouterr().out, returned[0]


def _legs(text):
    legs = []
    for line in text.splitlines():
        if line.startswith("method="):
            legs.append({"head": line, "rounds": [], "buckets": [], "cache": None})
        elif m := re.match(r" round (\d+): wall=\S+ mean_delta=(\S+) max_delta=(\S+)", line):
            legs[-1]["rounds"].append((float(m[2]), float(m[3])))
        elif m := re.match(r"  executable cache: hits=(\d+) misses=(\d+)", line):
            legs[-1]["cache"] = (int(m[1]), int(m[2]))
        elif m := re.match(r"  bucket B=\s*(\d+)\s+S=\s*(\d+)\s+calls=(\d+)\s+reqs=(\d+)", line):
            legs[-1]["buckets"].append(tuple(map(int, m.groups())))
    return legs


def _same_legs(got, want):
    lg, lw = _legs(got), _legs(want)
    assert len(lg) == len(lw) >= 1
    for g, w in zip(lg, lw):
        assert g["head"] == w["head"]
        assert g["buckets"] == w["buckets"] and g["cache"] == w["cache"]
        assert len(g["rounds"]) == len(w["rounds"])
        np.testing.assert_allclose(g["rounds"], w["rounds"], rtol=0, atol=DELTA_TOL)


def _same_ranking(got_idx, want_idx, scores):
    """Top positions equal, but where the two scores they swap lie within
    SCORE_TOL of the largest |score|."""
    mags = np.abs(np.fromiter(scores.values(), float) if isinstance(scores, dict) else scores)
    tol = SCORE_TOL * mags.max()
    for g, w in zip(got_idx, want_idx):
        assert g == w or abs(abs(scores[g]) - abs(scores[w])) <= tol, (got_idx, want_idx)


def _top5(text):
    m = re.search(r"top-5 attributed positions \(last round, req 0\): \[([^\]]*)\]", text)
    return [int(x) for x in m[1].split()]


@pytest.mark.parametrize("arch", ["llama3-8b", "whisper-tiny", "internvl2-26b"])
def test_explain_traffic_matches_repro(arch, f32, capsys, monkeypatch):
    argv = ["--arch", arch] + SMALL + (["--schedule", "uniform"] if arch != "llama3-8b" else [])
    want, got, engines = _both(capsys, monkeypatch, j_explain, explain, argv)
    _same_legs(got, want)
    assert ("frontend is stubbed" in got) == (arch != "llama3-8b") == ("frontend is stubbed" in want)
    # the last round's first request, drawn again, scored by the last leg's engine
    rng, cfg = np.random.default_rng(0), engines[-1].cfg
    for _ in range(2 * len(engines)):
        reqs = explain.make_traffic(cfg, 4, 9, 20, rng)
    scores = engines[-1].explain(reqs[:1])[0]["token_scores"]
    _same_ranking(_top5(got), _top5(want), scores)
    assert [e.schedule for e in engines] == (["paper", "uniform"] if arch == "llama3-8b" else ["uniform"])


def _table(text):
    return np.array([(int(m[1]), int(m[2]), float(m[3]))
                     for m in re.finditer(r"^\s+(\d+)\s+(\d+) ([+-]\S+)$", text, re.M)])


def test_explain_prompt_workload_matches_repro(f32, capsys, monkeypatch):
    argv = ["--arch", "whisper-tiny", "--workload", "prompt", "--m", "8", "--rounds", "2", "--fused",
            "--adaptive", "--m-max", "32"]
    want, got, engines = _both(capsys, monkeypatch, j_explain, explain, argv)
    _same_legs(got, want)
    tg, tw = _table(got), _table(want)
    assert tg.shape == tw.shape == (12, 3)
    np.testing.assert_array_equal(tg[:, :2], tw[:, :2])
    np.testing.assert_allclose(tg[:, 2], tw[:, 2], rtol=0, atol=SCORE_TOL * np.abs(tw[:, 2]).max() + 5e-7)
    # one fixed request: round 1 adds no miss
    assert re.findall(r"adaptive: .*", got) and all(e.stats.adaptive.requests == 2 for e in engines)


def test_explain_vit_workload_matches_repro(f32, capsys, monkeypatch):
    argv = ["--workload", "vit", "--m", "8", "--rounds", "2", "--attn", "flash", "--schedule", "uniform"]
    want, got, _ = _both(capsys, monkeypatch, j_explain, explain, argv)
    _same_legs(got, want)
    head = lambda t: re.search(r"vit workload: .*", t)[0]
    assert head(got) == head(want)
    pat = r"^  \((\d+), (\d+)\) ([+-]\S+)$"
    pg = [(int(m[1]), int(m[2]), float(m[3])) for m in re.finditer(pat, got, re.M)]
    pw = [(int(m[1]), int(m[2]), float(m[3])) for m in re.finditer(pat, want, re.M)]
    assert len(pg) == len(pw) == 5
    scores = np.array([s for *_, s in pw])
    np.testing.assert_allclose([s for *_, s in pg], scores, rtol=0, atol=SCORE_TOL * np.abs(scores).max())
    _same_ranking([p[:2] for p in pg], [p[:2] for p in pw], dict(((p[:2]), p[2]) for p in pw + pg))


def _first_sequence(text):
    return [int(x) for x in re.search(r"first sequence: \[([^\]]*)\]", text)[1].split()]


@pytest.mark.parametrize("arch", ["llama3-8b", "whisper-tiny", "internvl2-26b"])
def test_serve_classic_greedy_matches_repro(arch, f32, capsys, monkeypatch):
    argv = ["--arch", arch, "--prompt-len", "16", "--tokens", "16"]
    want, got, (engine, out) = _both(capsys, monkeypatch, j_serve, serve, argv)
    head = lambda t: re.search(r"arch=\S+ greedy generated \((\d+), (\d+)\)", t).groups()
    assert head(got) == head(want) == ("4", "16")
    n = 16 - (engine.cfg.frontend_tokens if arch == "internvl2-26b" else 0)
    assert _first_sequence(got)[:n] == _first_sequence(want)[:n]
    assert out.shape == (4, 16) and engine.max_len == 32 + 16 - n


def test_serve_mixed_matches_repro(f32, capsys, monkeypatch):
    argv = ["--mixed", "--tokens", "4", "--requests", "4", "--rounds", "2"]
    want, got, (sched, tickets) = _both(capsys, monkeypatch, j_serve, serve, argv)
    done = lambda t: re.findall(r"^round (\d+): (\d+)/(\d+) done", t, re.M)
    assert done(got) == done(want) == [("0", "4", "4"), ("1", "4", "4")]
    assert sched.engine.cfg.compute_dtype == "float32" and len(tickets) == 4


def test_serve_mixed_refuses_whisper():
    """``repro``'s run ends in ``KeyError: 'frontend'`` (``tests/
    test_torch_encdec.py`` holds its scheduler to it); the port's raises too."""
    with pytest.raises(ValueError, match="encoder-decoder"):
        serve.main(["--mixed", "--arch", "whisper-tiny", "--tokens", "2", "--requests", "3",
                    "--rounds", "1", "--device", "cpu"])


@pytest.mark.parametrize("main", [explain.main, serve.main])
def test_cuda_without_a_card_exits_non_zero(main, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        main(["--device", "cuda"])
    assert e.value.code not in (0, None)


@pytest.mark.parametrize("mesh, code", [("2,1", 2), ("1,4", 2)])
def test_mesh_is_one_card_only(mesh, code, capsys):
    """A mesh of more than one device needs as many processes (torchrun):
    a lone process exits 2 and says how to run it, before any group starts."""
    with pytest.raises(SystemExit) as e:
        explain.main(["--mesh", mesh, "--device", "cpu"])
    assert e.value.code == code and "torchrun --nproc-per-node" in capsys.readouterr().err
    assert not torch.distributed.is_initialized()


def test_sizing_flags():
    args = serve.parser().parse_args(["--arch", "internvl2-26b", "--full", "--layers", "4"])
    cfg = sized(get_config(args.arch), reduced, args)
    assert (cfg.d_model, cfg.num_layers, cfg.frontend_tokens) == (6144, 4, 256)
    args = explain.parser().parse_args(["--arch", "whisper-tiny"])
    assert sized(get_config(args.arch), reduced, args) == reduced(get_config("whisper-tiny"))
    assert explain.parser().parse_args([]).device == "cuda"
