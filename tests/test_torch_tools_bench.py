"""The port's measurement tools on the CPU (videopainter_tpu_torch/tools:
bench, sweep_int8_blocks, bench_vae_decode, convert_checkpoint), each held
to the JAX package's counterpart where one exists, at tiny widths.

- The bench's denoise step, batched CFG and sequential CFG, against the same
  composition of the JAX package's CogVideoXBranch / CogVideoXTransformer3D
  on the same weights (`convert.from_jax`) and numpy-seeded inputs, in
  float32 at `TransformerConfig.tiny`: atol / rtol 1e-4, the tolerance of
  `test_torch_modules.py` through a whole model.
- `gated_serving_rungs` against the JAX `bench._gated_serving_rungs` on the
  same artifact sets (the committed `_cuda` artifacts, copied under the JAX
  names for the JAX side), and the two cases where ADVICE.md's findings make
  the rules differ.
- `bench --tiny`'s line against the JAX `bench.py --tiny` line: the same
  keys, less the documented renames; the auto ladder's control flow with a
  stubbed subprocess layer.
- `bench_vae_decode` at a non-default tile and frame batch against the JAX
  VAE with the same tiling (VAEConfig.tiny, atol / rtol 1e-4 as the VAE tests).
- `sweep_int8_blocks --smoke` (256 tokens, blocks 128 x 256) against the JAX
  `flash_attention_int8` in interpret mode, one jitted program: atol 1e-5
  (`int8`) and 3e-3 (`int8pv`), the tolerances of `test_torch_int8.py`.
- `convert_checkpoint` round trips of tiny model directories and a SAM2 .pt.
"""

import importlib.util
import json
import shutil
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import videopainter_tpu.config as jcfg
from videopainter_tpu.models import AutoencoderKLCogVideoX as JVAE
from videopainter_tpu.models import CogVideoXBranch as JBranch
from videopainter_tpu.models import CogVideoXTransformer3D as JDiT
from videopainter_tpu_torch.config import BranchConfig, VAEConfig
from videopainter_tpu_torch.convert import (branch_state_dict, transformer_state_dict,
                                            vae_state_dict)
from videopainter_tpu_torch.models import (AutoencoderKLCogVideoX, CogVideoXBranch,
                                           CogVideoXTransformer3D)
from videopainter_tpu_torch.tools import bench, bench_vae_decode, convert_checkpoint
from videopainter_tpu_torch.tools import sweep_int8_blocks as sweep

REPO = Path(__file__).resolve().parents[1]
MODEL_TOL = 1e-4
INT8_ATOL = {False: 1e-5, True: 3e-3}


def T(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def random_params(init, seed):
    """As test_torch_modules.random_params: kernels N(0, 1/fan_in), norm
    scales 1 + N(0, 0.05^2), biases N(0, 0.05^2)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = jax.tree_util.keystr(path[-1:])
        r = rng.standard_normal(x.shape).astype(np.float32)
        if "kernel" in name:
            return r / np.sqrt(np.prod(x.shape[:-1]))
        return 1 + 0.05 * r if "scale" in name else 0.05 * r

    return jax.tree_util.tree_map_with_path(leaf, jax.eval_shape(init, jax.random.PRNGKey(0)))


def load_jax_bench():
    spec = importlib.util.spec_from_file_location("jax_bench", REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- (a) the denoise step against the JAX composition ---------------------------------------------

@pytest.fixture(scope="module")
def models():
    tcfg = bench.model_config(bench.parse_args(["--tiny"]))
    jt = jcfg.TransformerConfig.from_dict(tcfg.to_dict())
    jdit, jbranch = JDiT(jt), JBranch(jcfg.BranchConfig.from_transformer(jt, num_layers=2))
    params = {"transformer": random_params(jdit.init, 1), "branch": random_params(jbranch.init, 2)}
    t = CogVideoXTransformer3D(tcfg)
    t.load_state_dict(transformer_state_dict(params["transformer"]), strict=False)
    b = CogVideoXBranch(BranchConfig.from_transformer(tcfg, num_layers=2))
    b.load_state_dict(branch_state_dict(params["branch"]))
    return (jdit, jbranch, params), (t.eval(), b.eval()), tcfg


def step_inputs(tcfg, seed=3):
    from videopainter_tpu.pipelines.common import prepare_rope
    rng = np.random.default_rng(seed)
    b, t, h, w = bench.SMOKE_LATENT
    shape = (b, t, h, w, 16)
    cos, sin = prepare_rope(jcfg.TransformerConfig.from_dict(tcfg.to_dict()), h * 8, w * 8, t, 8)
    return {"latents": rng.standard_normal(shape).astype(np.float32),
            "masked": rng.standard_normal(shape).astype(np.float32),
            "image_latents": np.zeros(shape, np.float32),
            "mask": (rng.random((b, t, h, w)) > 0.5).astype(np.float32),
            "embeds": rng.standard_normal((2 * b, tcfg.max_text_seq_length,
                                           tcfg.text_embed_dim)).astype(np.float32),
            "rope": (np.asarray(cos, np.float32), np.asarray(sin, np.float32))}


def jax_steps(jdit, jbranch, params, inp, seq_cfg, steps):
    """The JAX bench's step (bench.py:509-558) composed from the JAX package's
    modules, exact attention (as its --tiny), `steps` times from t = 500."""
    x = {k: (tuple(jnp.asarray(r) for r in v) if k == "rope" else jnp.asarray(v))
         for k, v in inp.items()}
    b = x["latents"].shape[0]

    def forward_one(lat, masked, image, mask, e, ts):
        model_in = jnp.concatenate([lat, image], axis=-1)
        cond = jnp.concatenate([masked, mask[..., None]], axis=-1)
        samples = jbranch.apply(params["branch"], lat, e, cond, ts, rope=x["rope"],
                                use_flash=False)
        return jdit.apply(params["transformer"], model_in, e, ts, rope=x["rope"],
                          branch_block_samples=samples, branch_block_masks=mask,
                          use_flash=False).sample

    def batched(lat, t):
        two = lambda a: jnp.concatenate([a, a], axis=0)
        out = forward_one(two(lat), two(x["masked"]), two(x["image_latents"]), two(x["mask"]),
                          x["embeds"], jnp.broadcast_to(t, (2 * b,)))
        u, c = jnp.split(out.astype(jnp.float32), 2, axis=0)
        pred = u + 6.0 * (c - u)
        return (lat.astype(jnp.float32) * 0.99 - 0.01 * pred).astype(lat.dtype)

    def sequential(lat, t):
        ts = jnp.broadcast_to(t, (b,))
        u = forward_one(lat, x["masked"], x["image_latents"], x["mask"], x["embeds"][:b], ts)
        c = forward_one(lat, x["masked"], x["image_latents"], x["mask"], x["embeds"][b:], ts)
        pred = u.astype(jnp.float32) + 6.0 * (c - u).astype(jnp.float32)
        return (lat.astype(jnp.float32) * 0.99 - 0.01 * pred).astype(lat.dtype)

    step = jax.jit(sequential if seq_cfg else batched)
    lat = x["latents"]
    for i in range(steps):
        lat = step(lat, jnp.asarray(500 - i))
    return np.asarray(lat)


@pytest.mark.parametrize("seq_cfg", [False, True])
def test_bench_step_matches_jax_composition(models, seq_cfg):
    (jdit, jbranch, params), (t, b), tcfg = models
    inp = step_inputs(tcfg)
    ref = jax_steps(jdit, jbranch, params, inp, seq_cfg, steps=2)
    tin = {k: (tuple(T(r) for r in v) if k == "rope" else T(v)) for k, v in inp.items()}
    # use_flash=True: the flash kernel's plain version on the CPU, as the card runs B1
    step = bench.make_step(t, b, tin, True, seq_cfg)
    lat = tin["latents"]
    for i in range(2):
        lat = step(lat, 500 - i)
    np.testing.assert_allclose(lat.numpy(), ref, rtol=MODEL_TOL, atol=MODEL_TOL)
    assert not np.allclose(ref, inp["latents"], atol=1e-3)   # the step moved the latents


# -- (b) the gated headline against the JAX rule ---------------------------------------------------

JAX_NAMES = {bench.GATE_INT8: "GATE_int8.json", bench.SCALES: "calib_ascales.npz",
             bench.GATE_SKIP: "GATE_skip.json"}


def artifact_set(tmp_path, name, edit=None, files=tuple(JAX_NAMES)):
    """Two directories with the same content: the port's names and the JAX
    names. `edit(file, obj)` changes a JSON artifact before it is written."""
    port, jax_dir = tmp_path / name / "port", tmp_path / name / "jax"
    for d in (port, jax_dir):
        d.mkdir(parents=True)
    for f in files:
        src = REPO / f
        if f.endswith(".json"):
            obj = json.loads(src.read_text())
            if edit:
                edit(f, obj)
            text = json.dumps(obj)
            (port / f).write_text(text)
            (jax_dir / JAX_NAMES[f]).write_text(text)
        else:
            shutil.copy(src, port / f)
            shutil.copy(src, jax_dir / JAX_NAMES[f])
    return port, jax_dir


def picked(rungs):
    return [(name, args[args.index("--skip-spec") + 1] if "--skip-spec" in args else None)
            for name, args in rungs]


def both(monkeypatch, port, jax_dir):
    jb = load_jax_bench()
    monkeypatch.setattr(jb, "_REPO", str(jax_dir))
    return bench.gated_serving_rungs(port), jb._gated_serving_rungs()


def drop_static(f, obj):
    if f == bench.GATE_INT8:
        obj.pop("static_ascale", None)


def below_bar(f, obj):
    if f == bench.GATE_INT8:
        obj["latent"]["psnr_db"] = 30.0


SETS = {
    "none": dict(files=()),
    "int8_only": dict(files=(bench.GATE_INT8,), edit=drop_static),
    "int8_below_bar": dict(files=(bench.GATE_INT8, bench.SCALES), edit=below_bar),
    "int8_static": dict(files=(bench.GATE_INT8, bench.SCALES)),
    "int8_static_skip": dict(),
}
EXPECTED = {
    "none": [],
    "int8_only": [("int8_serving_42L", None)],
    "int8_below_bar": [],
    "int8_static": [("int8_ascale_serving_42L", None), ("int8_serving_42L", None)],
    "int8_static_skip": [("int8_ascale_skip_42L", "4:48:5"), ("int8_ascale_serving_42L", None),
                         ("int8_serving_42L", None)],
}


@pytest.mark.parametrize("name", list(SETS))
def test_gated_rungs_match_jax(tmp_path, monkeypatch, name):
    port, jax_dir = artifact_set(tmp_path, name, **SETS[name])
    (rungs, info), (jrungs, jinfo) = both(monkeypatch, port, jax_dir)
    assert picked(rungs) == picked(jrungs) == EXPECTED[name]
    assert info["status"] == jinfo["status"]
    for (_, a), (_, ja) in zip(rungs, jrungs):   # the same flags, the scales under each name
        assert [Path(x).name if x.endswith(".npz") else x for x in a] == \
            [bench.SCALES if x.endswith(".npz") else x for x in ja]
    if "skip_gate" in jinfo:
        assert info["skip_gate"] == {**jinfo["skip_gate"], "path": bench.GATE_SKIP}


def test_committed_artifacts_choose_the_skip_headline():
    rungs, info = bench.gated_serving_rungs(REPO)
    assert picked(rungs)[0] == ("int8_ascale_skip_42L", "4:48:5")
    assert "skip_gate_error" not in info


def fail_robustness_pixel(f, obj):
    if f == bench.GATE_SKIP:
        obj["robustness"]["configs"][0]["pixel_psnr_db"] = 30.0


def rename_robustness(f, obj):
    if f == bench.GATE_SKIP:
        obj["robustness"]["schedule"] = "4:48:5-renamed"


def test_robustness_pixel_below_bar_disqualifies_the_schedule(tmp_path, monkeypatch):
    """ADVICE.md (bench.py:171): the JAX rule reads only the robustness
    configs' latent PSNR and keeps 4:48:5; the port drops it and takes the
    next schedule that skips most (4:48:4)."""
    port, jax_dir = artifact_set(tmp_path, "rob_pixel", edit=fail_robustness_pixel)
    (rungs, info), (jrungs, _) = both(monkeypatch, port, jax_dir)
    assert picked(jrungs)[0] == ("int8_ascale_skip_42L", "4:48:5")
    assert picked(rungs)[0] == ("int8_ascale_skip_42L", "4:48:4")
    assert info["skip_gate"]["schedule"] == "4:48:4"


def test_renamed_robustness_schedule_drops_the_skip_rung(tmp_path, monkeypatch):
    """ADVICE.md (bench.py:181): with the robustness schedule not among the
    schedules the JAX guard is skipped and 4:48:5 still headlines; the port
    drops the skip rung and records `skip_gate_error`."""
    port, jax_dir = artifact_set(tmp_path, "rob_renamed", edit=rename_robustness)
    (rungs, info), (jrungs, jinfo) = both(monkeypatch, port, jax_dir)
    assert picked(jrungs)[0] == ("int8_ascale_skip_42L", "4:48:5")
    assert "skip_gate_error" not in jinfo
    assert picked(rungs) == [("int8_ascale_serving_42L", None), ("int8_serving_42L", None)]
    assert "4:48:5-renamed" in info["skip_gate_error"]


# -- (c) the result line and the auto ladder ---------------------------------------------------

RENAMED = {"compile_s": "first_step_s"}
DROPPED = {"flash_blocks"}
ADDED = {"peak_memory_gib", "launches", "environment"}


def last_json(text):
    return json.loads([ln for ln in text.splitlines() if ln.startswith("{")][-1])


def test_tiny_line_keys_match_jax_bench(capsys):
    jb = load_jax_bench()
    args = types.SimpleNamespace(layers=0, seq_cfg=False, steps=50, tiny=True, skip_vae=False,
                                 fuse_qkv=False, int8=False, int8_attn=False, int8_pv=False,
                                 int8_ascale=0.0, int8_scales=None, skip_spec=None,
                                 no_resident=False)
    jb.measure_rung(args)
    jline = last_json(capsys.readouterr().out)
    assert bench.main(["--tiny"]) == 0
    line = last_json(capsys.readouterr().out)
    assert set(line) == set(jline)
    want = {RENAMED.get(k, k) for k in jline["detail"]} - DROPPED | ADDED
    assert set(line["detail"]) == want
    assert line["metric"] == jline["metric"] and line["unit"] == jline["unit"]
    d = line["detail"]
    assert d["layers_measured"] == jline["detail"]["layers_measured"] == 2
    assert d["cfg_mode"] == "batched" and line["vs_baseline"] is None
    assert np.isfinite(line["value"]) and line["value"] > 0
    assert d["launches"]["flash_fwd"] == 0   # CPU tensors: the plain versions


def rung_result(step_ms, layers=42, vae_s=2.5, cfg_mode="batched"):
    clip = 50 * step_ms / 1e3 + vae_s
    return {"metric": bench.METRIC, "value": 60.0 / clip, "unit": bench.UNIT,
            "vs_baseline": None,
            "detail": {"step_ms_measured": step_ms, "layers_measured": layers,
                       "cfg_mode": cfg_mode, "vae_decode_s": vae_s}}


def run_auto(monkeypatch, capsys, outputs, probe_ok=True, budget=3300.0):
    """auto_main with subprocess.run stubbed: `outputs` maps a predicate on
    the rung's argv to a result dict, or to a stderr string (a failure)."""
    calls = []

    def fake_run(cmd, capture_output=True, text=True, timeout=None, cwd=None):
        res = types.SimpleNamespace(returncode=0, stdout="", stderr="")
        if "-c" in cmd:
            if probe_ok:
                res.stdout = "OK NVIDIA H100\n"
            else:
                res.returncode, res.stderr = 1, "AssertionError: no CUDA device"
            return res
        joined = " ".join(cmd)
        calls.append(joined)
        for pred, out in outputs:
            if pred(joined):
                if isinstance(out, str):
                    res.returncode, res.stderr = 1, out
                else:
                    res.stdout = "log line\n" + json.dumps(out) + "\n"
                return res
        res.returncode, res.stderr = 1, "RuntimeError: no such rung"
        return res

    monkeypatch.setattr(bench.subprocess, "run", fake_run)
    args = bench.parse_args(["--budget", str(budget)])
    rc = bench.auto_main(args)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    return rc, lines, calls


def is_skip(c):
    return "--skip-spec 4:48:5" in c


def is_bf16_42(c):
    return "--layers 42" in c and "--int8" not in c and "--seq-cfg" not in c


def test_auto_dead_backend_emits_error_line(monkeypatch, capsys):
    rc, lines, calls = run_auto(monkeypatch, capsys, [], probe_ok=False)
    assert rc == 1 and calls == []
    assert len(lines) == 1 and lines[0]["value"] == 0.0
    assert "cuda unavailable" in lines[0]["error"]


def test_auto_headline_first_then_bf16_baseline(monkeypatch, capsys):
    skip, bf16 = rung_result(3500.0), rung_result(2100.0, vae_s=0.0)
    rc, lines, calls = run_auto(monkeypatch, capsys, [
        (is_skip, skip), (is_bf16_42, bf16),
        (lambda c: "--int8 " in c + " " and "--int8-attn" not in c, rung_result(3000.0, vae_s=0)),
        (lambda c: "--int8-attn" in c, rung_result(3400.0, vae_s=0.0))])
    assert rc == 0 and is_skip(calls[0])
    first, last = lines[0], lines[-1]
    assert first["detail"]["headline_rung"] == "int8_ascale_skip_42L"
    assert first["vs_baseline"] is None   # no bf16 rung yet
    assert first["value"] == skip["value"] == last["value"]
    d = last["detail"]
    bf16_cpm = d["bf16_parity_mode"]["clips_per_min_per_chip"]
    assert bf16_cpm == pytest.approx(60.0 / (50 * 2.1 + 2.5))   # the headline's decode
    assert last["vs_baseline"] == pytest.approx(last["value"] / bf16_cpm)
    assert d["int8_static_ascale_mode"]["vs_baseline"] == pytest.approx(
        d["int8_static_ascale_mode"]["clips_per_min_per_chip"] / bf16_cpm)
    assert {"int8_proj_only_mode", "int8_dynamic_mode"} <= set(d)
    assert [r["rung"] for r in d["rungs"]] == ["int8_ascale_skip_42L", "bf16_batched_42L",
                                               "int8_proj_42L", "int8_serving_42L"]
    assert len(lines) == 5   # the headline, then a reprint after each rung, then the final


def test_auto_records_oom_and_falls_down_the_ladder(monkeypatch, capsys):
    oom = "torch.OutOfMemoryError: CUDA out of memory. Tried to allocate 2.00 GiB"
    rc, lines, calls = run_auto(monkeypatch, capsys, [
        (lambda c: "--int8" in c and "--skip-spec" not in c and "--skip-vae" not in c, oom),
        (is_skip, oom), (is_bf16_42, rung_result(2100.0)),
        (lambda c: "--int8-attn" in c, rung_result(3400.0, vae_s=0.0))])
    rungs = lines[-1]["detail"]["rungs"]
    assert [r.get("error") for r in rungs[:3]] == ["OOM", "OOM", "OOM"]
    assert lines[0]["detail"]["headline_rung"] == "bf16_batched_42L"
    assert lines[0]["vs_baseline"] == 1.0
    # the ungated int8 rung is a comparison, never the headline
    assert lines[-1]["detail"]["int8_full_fast_mode"]["layers_measured"] == 42
    assert lines[-1]["value"] == lines[0]["value"]


def test_auto_budget_skips_comparison_rungs(monkeypatch, capsys):
    rc, lines, _ = run_auto(monkeypatch, capsys, [(is_skip, rung_result(3500.0))], budget=200.0)
    skipped = [r for r in lines[-1]["detail"]["rungs"] if r.get("skipped")]
    assert [r["rung"] for r in skipped] == ["bf16_batched_42L", "int8_proj_42L",
                                            "int8_serving_42L"]
    assert lines[-1]["vs_baseline"] is None


# -- the card is never replaced by the CPU ----------------------------------------------------------

@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the behaviour without a card")
@pytest.mark.parametrize("tool, argv", [
    (bench, ["--layers", "2"]),
    (sweep, []),
    (bench_vae_decode, []),
    (convert_checkpoint, ["--src", "nowhere", "--dst", "nowhere"]),
])
def test_tools_raise_without_a_card(tool, argv):
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        tool.main(argv)


# -- (e) the decode sweep against the JAX VAE ---------------------------------------------------------

def test_vae_decode_combo_matches_jax():
    cfg_t, cfg_j = VAEConfig.tiny(), jcfg.VAEConfig.tiny()
    jp = random_params(JVAE(cfg_j).init, 7)
    m = AutoencoderKLCogVideoX(cfg_t)
    m.load_state_dict(vae_state_dict(jp))
    jv = JVAE(cfg_j)
    jv.enable_tiling(tile_sample_min_height=32, tile_sample_min_width=32)
    jv.num_latent_frames_batch_size = 1
    bench_vae_decode.set_combo(m, 32, 32, 1)
    assert (m.tile_latent_min_height, m.num_latent_frames_batch_size) == (4, 1)
    z = np.random.default_rng(11).standard_normal((1, 2, 8, 12, 4)).astype(np.float32)
    ref = np.asarray(jv.decode(jp, jnp.asarray(z)))
    res = bench_vae_decode.sweep(m, T(z), [("default", None, None, 2), ("32x32 fbs1", 32, 32, 1)])
    bench_vae_decode.set_combo(m, 32, 32, 1)
    out = m.decode(T(z)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=MODEL_TOL, atol=MODEL_TOL)
    rows = res["rows"]
    assert rows[0]["identical"] and rows[0]["psnr_vs_default"] is None
    assert np.isfinite(rows[1]["psnr_vs_default"]) and rows[1]["fps"] > 0
    assert res["best"] in rows


# -- (f) the block sweep against the JAX int8 flash attention ------------------------------------------

def test_int8_block_sweep_matches_jax(capsys):
    from videopainter_tpu.ops.flash_attention import flash_attention as jflash
    from videopainter_tpu.ops.flash_attention_int8 import flash_attention_int8 as jflash8

    assert sweep.main(["--smoke", "--pv"]) == 0
    res = last_json(capsys.readouterr().out)
    rows = {r["mode"]: r for r in res["rows"]}
    assert set(rows) == {"int8", "int8pv"} and res["shape"] == [1, 2, 256, 64]
    (bq, bk), = sweep.SMOKE_CANDIDATES
    q, k, v = (x.numpy() for x in sweep.operands(2, 256, torch.device("cpu"),
                                                 dtype=torch.float32))

    def jax_all():
        a = [jnp.asarray(x) for x in (q, k, v)]
        return (jflash(*a),) + tuple(jflash8(*a, blk_q=bq, blk_k=bk, int8_pv=pv)
                                     for pv in (False, True))

    with pltpu.force_tpu_interpret_mode():
        jb1, j8, j8pv = jax.tree.map(np.asarray, jax.jit(jax_all)())
    for pv, ref in ((False, j8), (True, j8pv)):
        out = sweep.flash_attention_int8(T(q), T(k), T(v), blk_q=bq, blk_k=bk,
                                         int8_pv=pv).numpy()
        np.testing.assert_allclose(out, ref, rtol=0, atol=INT8_ATOL[pv])
        jrel = np.abs(ref - jb1).mean() / (np.abs(jb1).mean() + 1e-9)
        row = rows["int8pv" if pv else "int8"]
        assert (row["blk_q"], row["blk_k"]) == (bq, bk)
        assert row["rel_l1"] == pytest.approx(jrel, rel=0.05, abs=1e-4)
    assert res["best"]["int8"]["ms"] > 0


def test_int8_block_sweep_prints_failed_blocks(capsys, monkeypatch):
    """A block that B4's 128-row / 128-key tiles do not divide raises
    ValueError in the CUDA wrapper (the CPU's plain version takes any
    block): the sweep prints it as FAILED and goes on."""
    plain = sweep.flash_attention_int8

    def like_the_card(q, k, v, *, blk_q, blk_k, int8_pv):
        if blk_q % 128 or blk_k % 128:
            raise ValueError(f"blk_q {blk_q} / blk_k {blk_k}: not multiples of the tiles")
        return plain(q, k, v, blk_q=blk_q, blk_k=blk_k, int8_pv=int8_pv)

    monkeypatch.setattr(sweep, "flash_attention_int8", like_the_card)
    q, k, v = sweep.operands(1, 256, torch.device("cpu"), dtype=torch.float32)
    res = sweep.sweep(q, k, v, [(128, 256), (100, 256)], [False], iters=1)
    assert "ms" in res["rows"][0]
    assert "failed" in res["rows"][1] and "FAILED" in capsys.readouterr().out
    assert res["best"]["int8"] is res["rows"][0]


# -- (g) checkpoint round trips ------------------------------------------------------------------------

def tiny_checkpoint(root):
    from videopainter_tpu_torch.config import TransformerConfig
    from videopainter_tpu_torch.training import checkpoint as ckpt

    g = torch.Generator().manual_seed(0)
    tcfg = TransformerConfig.tiny(in_channels=32, out_channels=16, sample_height=8,
                                  sample_width=12)
    vcfg = VAEConfig.tiny(latent_channels=16)
    dit = CogVideoXTransformer3D(tcfg).init_random_(g)
    br = CogVideoXBranch(BranchConfig.from_transformer(tcfg, num_layers=2)).init_random_(g)
    vae = AutoencoderKLCogVideoX(vcfg).init_random_(g)
    ckpt.export_transformer_pretrained(dit, tcfg.to_dict(), str(root / "model" / "transformer"),
                                       max_shard_bytes=20_000)
    ckpt.export_vae_pretrained(vae, vcfg.to_dict(), str(root / "model" / "vae"))
    ckpt.export_branch_pretrained(br, br.cfg.to_dict(), str(root / "branch"))
    (root / "model" / "scheduler").mkdir()
    (root / "model" / "scheduler" / "scheduler_config.json").write_text("{}")
    return dit, br, vae


def test_convert_checkpoint_round_trip_loads_in_build_pipeline(tmp_path, capsys):
    from videopainter_tpu_torch.infer.inpaint import build_pipeline

    dit, br, vae = tiny_checkpoint(tmp_path / "src")
    dst = tmp_path / "dst"
    assert convert_checkpoint.main(["--src", str(tmp_path / "src" / "model"),
                                    "--dst", str(dst / "model"),
                                    "--branch", str(tmp_path / "src" / "branch"),
                                    "--branch_dst", str(dst / "branch"),
                                    "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[ok] transformer" in out and "[ok] vae" in out and "[ok] branch" in out
    assert "[ok] scheduler: 1 files" in out and "text_encoder missing" in out
    assert (dst / "model" / "transformer" /
            "diffusion_pytorch_model.safetensors.index.json").exists()
    pipe = build_pipeline(str(dst / "model"), str(dst / "branch"), dtype_str="float32",
                          device="cpu")
    for src, got in ((dit, pipe.transformer), (br, pipe.branch), (vae, pipe.vae)):
        want = src.state_dict()
        for name, x in got.state_dict().items():
            assert torch.equal(x, want[name]), name


def test_convert_checkpoint_refuses_a_missing_tensor(tmp_path):
    from videopainter_tpu_torch.convert import load_safetensors_dir, save_safetensors_dir

    tiny_checkpoint(tmp_path / "src")
    vae_dir = tmp_path / "src" / "model" / "vae"
    sd = load_safetensors_dir(str(vae_dir))
    sd.pop(sorted(sd)[0])
    for f in vae_dir.glob("*.safetensors"):
        f.unlink()
    save_safetensors_dir(sd, str(vae_dir))
    with pytest.raises(RuntimeError, match="Missing key"):
        convert_checkpoint.main(["--src", str(tmp_path / "src" / "model"),
                                 "--dst", str(tmp_path / "dst"), "--device", "cpu"])


def test_convert_sam2_checkpoint_loads_in_the_predictor(tmp_path):
    from videopainter_tpu_torch.segmentation import build_sam2_video_predictor

    torch.manual_seed(0)
    ref = build_sam2_video_predictor("tiny", None, image_size=64, device="cpu")
    sd = {k: v.clone() for k, v in ref.state_dict().items()}
    torch.save({"model": sd}, tmp_path / "sam2_in.pt")
    dst = tmp_path / "out" / "sam2.pt"
    assert convert_checkpoint.main(["--sam2", str(tmp_path / "sam2_in.pt"), "--sam2_dst",
                                    str(dst), "--device", "cpu"]) == 0
    assert convert_checkpoint.sam2_variant(sd) == "tiny"
    assert set(torch.load(dst)) == set(sd)   # the bare state dict, no "model" wrapper
    got = build_sam2_video_predictor("tiny", str(dst), image_size=64, device="cpu")
    for k, v in got.state_dict().items():
        assert torch.equal(v, sd[k]), k
    # A trunk of no published depth, and a tensor missing outside the trunk.
    no_variant = {k: v for k, v in sd.items()
                  if not k.startswith("image_encoder.trunk.blocks.11.")}
    torch.save(no_variant, tmp_path / "no_variant.pt")
    with pytest.raises(ValueError, match="11-block trunk"):
        convert_checkpoint.main(["--sam2", str(tmp_path / "no_variant.pt"), "--sam2_dst",
                                 str(dst), "--device", "cpu"])
    missing = dict(sd)
    missing.pop("no_mem_embed")
    torch.save(missing, tmp_path / "missing.pt")
    with pytest.raises(RuntimeError, match="Missing key"):
        convert_checkpoint.main(["--sam2", str(tmp_path / "missing.pt"), "--sam2_dst",
                                 str(dst), "--device", "cpu"])
