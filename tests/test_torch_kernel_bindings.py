"""The ctypes bindings of the port's CUDA kernels against their C entry points.

Each `extern "C"` function of `videopainter_tpu_torch/csrc/*.cu` is parsed
from its source and held against the `argtypes` its wrapper gives ctypes:
the same number of arguments and the same kinds (pointer -> c_void_p,
`long long` -> c_longlong, `int` -> c_int, `float` -> c_float). A wrong kind
would silently cut a pointer or a stride at the call, and no test without a
card could see it otherwise. Plain file parsing: no build, no card.
"""

import ast
import ctypes
import re
from pathlib import Path

import pytest

from videopainter_tpu_torch import _kernels, native
from videopainter_tpu_torch.ops import flash_attention as fa
from videopainter_tpu_torch.ops import flash_attention_int8 as fa8
from videopainter_tpu_torch.ops import adaln, group_norm, qk_prep

_ENTRY = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)\s*\{', re.S)


def c_kind(param: str):
    """The ctypes type a C parameter declaration must be bound with."""
    decl = " ".join(param.split())
    if "*" in decl:
        return ctypes.c_void_p
    words = decl.split()[:-1]          # drop the parameter's name
    kind = " ".join(w for w in words if w != "const")
    return {"long long": ctypes.c_longlong, "int": ctypes.c_int,
            "float": ctypes.c_float}[kind]


def parse_entries(text: str):
    """{function: [ctypes kind of each parameter]} of a source's C entries."""
    return {m.group(1): [c_kind(p) for p in m.group(2).split(",")]
            for m in _ENTRY.finditer(text)}


def bindings():
    """{(source, function): argtypes} of every wrapper module."""
    out = {}
    for source, signatures in (*fa.SOURCES, *fa8.SOURCES, *native.SOURCES, *qk_prep.SOURCES,
                              *group_norm.SOURCES, *adaln.SOURCES):
        for name, argtypes in signatures.items():
            out[(source, name)] = argtypes
    return out


def entries():
    out = {}
    for path in sorted(_kernels.CSRC.glob("*.cu")):
        for name, kinds in parse_entries(path.read_text()).items():
            out[(path.name, name)] = kinds
    return out


_ENTRIES = entries()


def test_every_entry_point_is_bound_and_every_binding_exists():
    assert len(_ENTRIES) >= 9
    assert set(bindings()) == set(_ENTRIES)


@pytest.mark.parametrize("key", sorted(_ENTRIES), ids=lambda k: f"{k[0]}::{k[1]}")
def test_argtypes_match_the_c_entry_point(key):
    want = _ENTRIES[key]
    got = bindings()[key]
    assert len(got) == len(want), f"{key}: {len(got)} argtypes for {len(want)} parameters"
    for i, (g, w) in enumerate(zip(got, want)):
        assert g is w, f"{key} argument {i}: bound as {g.__name__}, declared {w.__name__}"


def test_parser_reads_each_kind():
    text = '''// comment
extern "C" int vp_x(const void* a, void* b, int n,
                    long long s, float f, void* stream) {
  return 0;
}
int helper(int a) { return a; }'''
    assert parse_entries(text) == {"vp_x": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                            ctypes.c_longlong, ctypes.c_float,
                                            ctypes.c_void_p]}
    with pytest.raises(KeyError):
        c_kind("double x")


# the warp-specialised Hopper kernels, on hopper.cuh's TMA, mbarrier and wgmma PTX
WGMMA_SOURCES = ("flash_fwd_wgmma.cu", "flash_dkv_wgmma.cu", "flash_dq_wgmma.cu",
                 "flash_int8_wgmma.cu", "flash_int8_uniform_wgmma.cu")


def test_wgmma_kernels_share_the_hopper_header_and_trap_their_waits():
    """Each wgmma source includes hopper.cuh and issues its wgmma products;
    its waits trap and its entry refuses a register count setmaxnreg cannot
    feed."""
    for source in WGMMA_SOURCES:
        text = (_kernels.CSRC / source).read_text()
        assert '#include "hopper.cuh"' in text and "wgmma_" in text
        assert "mbar_wait" in text and "check_registers" in text
    header = (Path(_kernels.CSRC) / "hopper.cuh").read_text()
    assert "setmaxnreg" in header and "cp.async.bulk.tensor.4d" in header
    assert "__trap()" in header and "ERR_REGISTERS" in header


def launch_sites():
    """{launch key: [(module, function, whether the function loads a kernel
    library)]} of every `LAUNCHES[key] += 1` in the port's sources."""
    port = Path(_kernels.__file__).resolve().parent
    sites = {}
    for path in sorted(port.rglob("*.py")):
        tree = ast.parse(path.read_text())
        for fn in ast.walk(tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            calls = {ast.unparse(n.func) for n in ast.walk(fn) if isinstance(n, ast.Call)}
            for node in ast.walk(fn):
                if (isinstance(node, ast.AugAssign) and isinstance(node.op, ast.Add)
                        and isinstance(node.target, ast.Subscript)
                        and ast.unparse(node.target.value).endswith("LAUNCHES")):
                    key = ast.literal_eval(node.target.slice)
                    sites.setdefault(key, []).append(
                        (str(path.relative_to(port)), fn.name, "_kernels.load" in calls))
    return sites


_LAUNCH_SITES = launch_sites()


@pytest.mark.parametrize("key", sorted(_kernels.LAUNCHES))
def test_one_wrapper_counts_each_launch_key(key):
    """As `_kernels.py` promises: a wrapper adds one to a kernel's key where
    it launches that kernel (it loads the library) and nowhere else; and no
    source counts a key that `LAUNCHES` lacks."""
    sites = _LAUNCH_SITES.get(key, [])
    assert len(sites) == 1, f"{key} is counted at {sites}"
    module, function, loads = sites[0]
    assert loads, f"{module}::{function} counts {key} but builds no kernel"
    assert set(_LAUNCH_SITES) <= set(_kernels.LAUNCHES)


@pytest.mark.parametrize("rc,match", [(-1, "cuTensorMapEncodeTiled"), (-2, "tensor map"),
                                      (-3, "setmaxnreg"), (700, "CUDA error 700")])
def test_launch_error_codes_raise_with_their_meaning(rc, match):
    with pytest.raises(RuntimeError, match=match):
        _kernels.check(rc, "kernel")
    _kernels.check(0, "kernel")


def test_library_name_hashes_the_shared_headers(tmp_path, monkeypatch):
    """An edit of csrc/*.cuh rebuilds every source that includes it."""
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_kernels, "CSRC", tmp_path)
    first = _kernels._lib_path("k.cu")
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _kernels._lib_path("k.cu") != first
    assert first.name.startswith("libk_")


def test_uniform_int8_entry_is_bound_to_the_hopper_kernel():
    """`int8_flash_uniform` launches csrc/flash_int8_uniform_wgmma.cu under the
    launch key flash_int8_uniform_fwd. The source folds the score conversion
    into the softmax's FMA (the 1.5 * 2^23 shift) and keeps no scale table."""
    import inspect

    assert fa8._UNIFORM_SOURCE == "flash_int8_uniform_wgmma.cu"
    assert (fa8._UNIFORM_SOURCE, fa8._UNIFORM_SIGNATURES) in fa8.SOURCES
    body = inspect.getsource(fa8.int8_flash_uniform)
    assert "_UNIFORM_SOURCE" in body and '"flash_int8_uniform_fwd"' in body
    assert "flash_int8_uniform_fwd" in _kernels.LAUNCHES
    text = (_kernels.CSRC / fa8._UNIFORM_SOURCE).read_text()
    assert "0x4B400000" in text and "__fmul_ru" in text and "issue_qk" in text
    assert "sk_row" not in text and "kv_page" not in text
    # the int8 kernels' common parts (tiles, P packing, the s8 / bf16 wgmma issue)
    shared = (_kernels.CSRC / "int8_wgmma.cuh").read_text()
    assert "wgmma_ss_m64n128_s8" in shared and "pack_p8" in shared
    for source in (fa8._SOURCE, fa8._UNIFORM_SOURCE):
        assert '#include "int8_wgmma.cuh"' in (_kernels.CSRC / source).read_text()
