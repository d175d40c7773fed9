"""Port hygiene for `repro_torch`: import isolation from JAX and `repro`,
device defaults, the refusals of later-slice options, config copies and
the kernel wrappers' input checks."""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch import runtime
from repro_torch.configs import base as TCB
from repro_torch.engine import EngineConfig, ServeEngine
from repro_torch.kernels import build as KB
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import build_model

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted(str(p.relative_to(ROOT))
                    for p in (ROOT / "src" / "repro_torch").rglob("*.py")) \
    + ["chip_smoke.py"]
DENSE = ("qwen3-32b", "minitron-4b", "gemma-7b")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep \
        + env.get("PYTHONPATH", "")
    return env


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")


# ------------------------------------------------------------ isolation
def test_import_leaves_jax_out():
    code = ("import sys, repro_torch, repro_torch.engine, "
            "repro_torch.launch.serve, repro_torch.bridge; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'repro.')) or m == 'repro'); "
            "print(bad); assert not bad, bad")
    res = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("path", PORT_FILES)
def test_no_jax_or_repro_import(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:               # relative: stays inside the port
                continue
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), \
                f"{path}:{node.lineno} imports {n}"


# --------------------------------------------------------------- devices
def test_default_device_raises_without_card():
    _no_card()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        runtime.resolve_device(None)


@pytest.mark.parametrize("entry", ["init", "engine", "cli", "bridge"])
def test_entry_points_default_to_cuda(entry):
    _no_card()
    cfg = TCB.get_reduced("qwen3-32b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if entry == "init":
            build_model(cfg).init()
        elif entry == "engine":
            ServeEngine.from_config(EngineConfig(arch="qwen3-32b",
                                                 reduced=True, max_len=32))
        elif entry == "cli":
            from repro_torch.launch import serve
            serve.main(["--arch", "qwen3-32b", "--reduced", "--requests",
                        "1"])
        else:
            from repro_torch.bridge import params_from_numpy
            import numpy as np
            params_from_numpy({"w": np.zeros(2, np.float32)})


def test_explicit_cpu_runs():
    cfg = TCB.get_reduced("qwen3-32b")
    params = build_model(cfg).init(device="cpu")
    assert params["embed"]["table"].device.type == "cpu"
    eng = ServeEngine.from_config(EngineConfig(arch="qwen3-32b",
                                               reduced=True, max_len=32),
                                  device="cpu")
    assert eng.device.type == "cpu"


# ---------------------------------------------------- later-slice options
LATER_FLAGS = {
    "mesh": (["--model-mesh", "2"], "7"),
}


@pytest.mark.parametrize("name", sorted(LATER_FLAGS))
def test_later_slice_flags_raise(name, tmp_path, capsys):
    """Refused until the model axis came (the name is from then).
    `--model-mesh 2` on one device falls back to a (1, 1) mesh, as the
    reference CLI's does, so it serves the tokens of the run without the
    flag, bitwise, from the same checkpoint; each request's first token
    (the prefill's) is the reference CLI's. (Both CLIs compute in bf16,
    whose CPU rounding differs between the frameworks, so later tokens
    may part.) A grid the ranks cannot fill still names its item."""
    pytest.importorskip("jax")
    from repro.launch import serve as jserve
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.engine import EngineConfig
    from repro_torch.launch import serve
    CheckpointManager(tmp_path).save(3, {"params": build_model(
        TCB.get_reduced("qwen3-32b")).init(torch.Generator().manual_seed(1),
                                       device="cpu"), "step": 3})
    argv = ["--arch", "qwen3-32b", "--reduced", "--requests", "3",
            "--gen", "6", "--prompt-len", "12", "--max-slots", "2",
            "--ckpt-dir", str(tmp_path)]
    flags, item = LATER_FLAGS[name]
    plain = serve.main(argv + ["--device", "cpu"])
    got = serve.main(argv + flags + ["--device", "cpu"])
    want = jserve.main(argv + flags)
    capsys.readouterr()
    assert [h.tokens for h in got] == [h.tokens for h in plain]
    assert [h.tokens[0] for h in got] == [h.tokens[0] for h in want]
    with pytest.raises(NotImplementedError,
                       match=rf"ROADMAP.md queue 1, item {item}\b"):
        EngineConfig(data_mesh=1, model_mesh=2).rank_mesh(4)


def test_recurrent_family_serves_on_cpu(capsys):
    """`--arch rwkv6-7b`, refused until ROADMAP item 6 was done, now
    serves (the dense fallback of the ssm family, scan prefill)."""
    import warnings
    from repro_torch.launch import serve
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        serve.main(["--arch", "rwkv6-7b", "--reduced", "--device", "cpu",
                    "--requests", "1", "--gen", "2", "--prompt-len", "8"])
    out = capsys.readouterr().out
    assert "completed=1" in out and "kv layout=dense" in out


# the serve flags ROADMAP item 5 brought: each runs on the CPU, and the
# check shows it took effect (the output it prints, or what it changed)
ITEM5_FLAGS = {
    "speculation": ["--speculation-k", "2"],
    "draft": ["--speculation-k", "2", "--draft-preset", "qwen3-32b"],
    "deadline": ["--deadline-s", "1e-6"],
    "retries": ["--max-retries", "0", "--kv-pages", "3"],
    "ladder": ["--pressure-ladder", "--kv-pages", "3"],
    "dense_layout": ["--kv-layout", "dense"],
    "legacy": ["--legacy"],
    "scan_prefill": ["--prefill-mode", "scan"],
    "preemption": ["--kv-pages", "3"],
}


def _field(out: str, key: str) -> float:
    import re
    return float(re.search(rf"\b{key}=([0-9.]+)", out).group(1))


@pytest.mark.parametrize("name", sorted(ITEM5_FLAGS))
def test_item5_flags_serve_on_cpu(name, capsys, monkeypatch):
    from repro_torch.engine.serving import engine as E
    from repro_torch.launch import serve
    scans = []
    make_scan = E._make_scan_prefill
    monkeypatch.setattr(E, "_make_scan_prefill",
                        lambda *a: scans.append(a) or make_scan(*a))
    argv = ["--arch", "qwen3-32b", "--reduced", "--device", "cpu",
            "--requests", "3", "--gen", "6", "--prompt-len", "12",
            "--max-slots", "2"] + ITEM5_FLAGS[name]
    got = serve.main(argv)
    out = capsys.readouterr().out
    if name == "legacy":
        assert "[serve] legacy completed=3 generated_tokens=18" in out
        assert got.shape == (3, 12 + 6)
        return
    assert all(h.done for h in got)
    if name in ("speculation", "draft"):
        assert _field(out, "ticks") > 0 and _field(out, "draft_prefills") == 3
    elif name == "deadline":
        assert [h.finish_reason for h in got] == ["deadline"] * 3
        assert _field(out, "deadline_kills") == 3
    elif name == "retries":
        assert "retries" in [h.finish_reason for h in got]
        assert _field(out, "failed") >= 1
    elif name == "ladder":
        assert _field(out, "degradation_changes") > 0
    elif name == "dense_layout":
        assert "[serve] kv layout=dense" in out
    elif name == "scan_prefill":
        assert len(scans) == 1 and _field(out, "completed") == 3
    else:
        assert _field(out, "preemptions") > 0 and _field(out, "completed") == 3


# ------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("reduced", [False, True])
def test_config_copies_match_reference(arch, reduced):
    pytest.importorskip("jax")
    from repro.configs import base as JCB
    get_t = TCB.get_reduced if reduced else TCB.get_config
    get_j = JCB.get_reduced if reduced else JCB.get_config
    assert dataclasses.asdict(get_t(arch)) == dataclasses.asdict(get_j(arch))
    assert [f.name for f in dataclasses.fields(TCB.ModelConfig)] == \
        [f.name for f in dataclasses.fields(JCB.ModelConfig)]


@pytest.mark.parametrize("arch", DENSE)
def test_param_count_matches_reference(arch):
    pytest.importorskip("jax")
    from repro.configs.base import get_config
    assert TCB.get_config(arch).param_count() == \
        get_config(arch).param_count()


@pytest.mark.parametrize("kw", [dict(max_len=40), dict(max_len=0),
                                dict(max_len=33, page_size=8),
                                dict(max_len=16, page_size=16)])
def test_engine_config_serve_len_matches_reference(kw):
    pytest.importorskip("jax")
    from repro.engine.config import EngineConfig as JEC
    assert EngineConfig(**kw).serve_max_len() == JEC(**kw).serve_max_len()


@pytest.mark.parametrize("kw,err", [
    (dict(max_slots=0), ValueError), (dict(max_len=-1), ValueError),
    (dict(page_size=0), ValueError), (dict(kv_pages=1), ValueError),
    (dict(prefill_mode="bogus"), ValueError),
    (dict(param_dtype="float16"), ValueError),
    (dict(kv_layout="dense"), None)])
def test_engine_config_validate(kw, err):
    if err is None:                 # a valid config validates to itself
        cfg = EngineConfig(**kw)
        assert cfg.validate() is cfg
        return
    with pytest.raises(err):
        EngineConfig(**kw).validate()


# ------------------------------------------------------ wrapper checks
def _qkv(B=1, T=8, S=8, H=4, KV=2, Dh=16, dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    return (torch.randn(B, T, H, Dh, generator=g, dtype=dtype),
            torch.randn(B, S, KV, Dh, generator=g, dtype=dtype),
            torch.randn(B, S, KV, Dh, generator=g, dtype=dtype))


@pytest.mark.parametrize("bad", ["noncontig", "dtype_mix", "float16",
                                 "heads", "head_dim", "offset"])
def test_flash_wrapper_rejects(bad):
    q, k, v = _qkv()
    kw = {}
    if bad == "noncontig":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "dtype_mix":
        k = k.to(torch.bfloat16)
    elif bad == "float16":
        q, k, v = (x.half() for x in (q, k, v))
    elif bad == "heads":
        q = q[:, :, :3].contiguous()
    elif bad == "head_dim":
        k, v = k[..., :8].contiguous(), v[..., :8].contiguous()
    else:
        kw["q_offset"] = -1
    with pytest.raises(ValueError):
        FA.flash_attention(q, k, v, **kw)


@pytest.mark.parametrize("bad", ["table_dtype", "pos_shape", "noncontig"])
def test_paged_wrapper_rejects(bad):
    q = torch.zeros(2, 4, 16)
    kp = torch.zeros(5, 4, 2, 16)
    vp = torch.zeros(5, 4, 2, 16)
    pt = torch.ones(2, 2, dtype=torch.int32)
    pos = torch.zeros(2, dtype=torch.int32)
    if bad == "table_dtype":
        pt = pt.long()
    elif bad == "pos_shape":
        pos = torch.zeros(3, dtype=torch.int32)
    else:
        kp = kp.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError):
        FA.paged_decode_attention(q, kp, vp, pt, pos)


def test_cpu_wrappers_take_plain_path_without_counting():
    KB.reset_launches()
    q, k, v = _qkv()
    out = FA.flash_attention(q, k, v, causal=True)
    assert torch.equal(out, FA.flash_attention_ref(q, k, v, causal=True))
    assert set(KB.LAUNCHES) == {"flash_attention", "paged_decode_attention",
                                "block_dots", "block_combine"}
    assert all(n == 0 for n in KB.LAUNCHES.values())
