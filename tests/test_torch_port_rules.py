"""Rules of the PyTorch/CUDA port that a CPU run can check.

- qnnpack_tpu_torch (parallel/ included), chip_smoke.py,
  parallel_smoke.py and the module
  that the parallel tests' spawned processes import
  (tests/torch_parallel_worlds.py) import neither jax nor qnnpack_tpu,
  nor flatbuffers (the TFLite importer reads the file itself);
- the entry points raise when a GPU is asked for and absent;
- every C entry point of kernels/csrc/ switches the CUDA device only
  through qnn::DeviceGuard, which gives the caller's device back;
- a forward on CPU tensors runs the plain versions and launches nothing;
- the ctypes bindings agree with the C entry points of kernels/csrc/, and
  the scheme codes with csrc/requant.cuh;
- chip_smoke.py fails, printing no result, without a GPU or without the
  rest of the repository;
- no module of the forward path (models/, nn/, kernels/, parallel/) waits
  for the device or copies to the host (torch.cuda.synchronize, .item(), .cpu(),
  .tolist(), .numpy()), any of which would break a CUDA-graph capture.
"""

import ast
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from qnnpack_tpu_torch import io as tio
from qnnpack_tpu_torch import kernels as tkernels
from qnnpack_tpu_torch import ops as tops
from qnnpack_tpu_torch.device import resolve_device
from qnnpack_tpu_torch.entry import entry
from qnnpack_tpu_torch.kernels import _build
from qnnpack_tpu_torch.models import bert as tbert
from qnnpack_tpu_torch.models import graph as tgraph
from qnnpack_tpu_torch.models import mobilenet_v2 as tm
from qnnpack_tpu_torch.models import zoo as tzoo
from qnnpack_tpu_torch.nn.requant_dispatch import make_requant_params
from qnnpack_tpu_torch.quant import params as tparams
from qnnpack_tpu_torch.serving import InferenceServer

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "qnnpack_tpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py", ROOT / "parallel_smoke.py",
     ROOT / "tests" / "torch_parallel_worlds.py"]


def imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_no_jax(path):
    for mod in imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "qnnpack_tpu", "flatbuffers"), \
            f"{path.relative_to(ROOT)} imports {mod}"


def test_port_files_were_found():
    assert len(PORT_FILES) > 15
    parallel = ROOT / "qnnpack_tpu_torch" / "parallel"
    assert {p.name for p in PORT_FILES if p.parent == parallel} == {
        "__init__.py", "mesh.py", "halo.py", "expert.py", "pipeline.py",
        "multihost.py"}
    assert ROOT / "qnnpack_tpu_torch" / "nn" / "shard.py" in PORT_FILES


FORWARD_PATH = sorted(p for d in ("models", "nn", "kernels", "parallel")
                      for p in (ROOT / "qnnpack_tpu_torch" / d).rglob("*.py"))
HOST_SYNCS = {"synchronize", "item", "cpu", "tolist", "numpy"}


def host_syncs(source: str):
    """(line, name) of every call of a HOST_SYNCS method in `source`."""
    for node in ast.walk(ast.parse(source)):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr in HOST_SYNCS):
            yield node.lineno, node.func.attr


@pytest.mark.parametrize("path", FORWARD_PATH,
                         ids=[str(p.relative_to(ROOT)) for p in FORWARD_PATH])
def test_forward_path_never_waits_for_the_device(path):
    assert list(host_syncs(path.read_text())) == []


def test_host_sync_scan_finds_each_call():
    assert len(FORWARD_PATH) > 15
    found = list(host_syncs(
        "import torch\ntorch.cuda.synchronize()\nx.item()\ny = x.cpu()\n"
        "z = f(x).tolist()\nw = x.numpy()\nx.cpu\n"))
    assert [name for _, name in found] == ["synchronize", "item", "cpu",
                                           "tolist", "numpy"]


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_defaults_to_gpu_and_raises_without_one(no_gpu):
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        entry()


def test_resnet18_entry_and_zoo_raise_without_gpu(no_gpu):
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        entry(model="resnet18")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tzoo.resnet18(np.random.default_rng(0))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tgraph.GraphBuilder(np.random.default_rng(0))


def test_shufflenet_entry_and_zoo_raise_without_gpu(no_gpu):
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        entry(model="shufflenet_v1_g3")
    for builder in (tzoo.shufflenet_v1, tzoo.shufflenet_v2):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            builder(np.random.default_rng(0))


def test_enet_entry_and_builder_raise_without_gpu(no_gpu):
    from qnnpack_tpu_torch.models.enet import enet_seg
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        entry(model="enet_seg")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        enet_seg(np.random.default_rng(0))


def test_bert_entry_and_builder_raise_without_gpu(no_gpu):
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        entry(model="bert_base_s128")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tbert.build_bert_encoder(np.random.default_rng(0),
                                 tbert.BertConfig(layers=1))


@pytest.mark.parametrize("name,kwargs", [
    ("Add", dict(a_zero_point=0, a_scale=1.0, b_zero_point=0, b_scale=1.0,
                 sum_zero_point=0, sum_scale=1.0)),
    ("Clamp", {}),
    ("Sigmoid", dict(input_zero_point=0, input_scale=0.1)),
    ("LeakyReLU", dict(negative_slope=0.1, input_zero_point=0,
                       input_scale=0.1, output_zero_point=0,
                       output_scale=0.1)),
    ("SoftArgMax", dict(channels=8, input_scale=0.1)),
    ("ChannelShuffle", dict(groups=2, group_channels=4)),
    ("Convolution2D", dict(kernel=np.zeros((4, 3, 3, 2), np.uint8), bias=None,
                           input_zero_point=0, input_scale=0.1,
                           kernel_zero_point=0, kernel_scale=0.1,
                           output_zero_point=0, output_scale=1.0)),
    ("Deconvolution2D", dict(kernel=np.zeros((4, 2, 2, 2), np.uint8),
                             bias=None, input_zero_point=0, input_scale=0.1,
                             kernel_zero_point=0, kernel_scale=0.1,
                             output_zero_point=0, output_scale=1.0,
                             strides=(2, 2))),
    ("FullyConnected", dict(kernel=np.zeros((4, 2), np.uint8), bias=None,
                            input_zero_point=0, input_scale=0.1,
                            kernel_zero_point=0, kernel_scale=0.1,
                            output_zero_point=0, output_scale=1.0)),
    ("MaxPooling2D", dict(pool_size=(2, 2))),
    ("AveragePooling2D", dict(pool_size=(2, 2), input_zero_point=0,
                              input_scale=0.1, output_zero_point=0,
                              output_scale=0.1)),
    ("GlobalAveragePooling", dict(channels=8, input_zero_point=0,
                                  input_scale=0.1, output_zero_point=0,
                                  output_scale=0.1))])
def test_operators_default_to_gpu_and_raise_without_one(no_gpu, name,
                                                        kwargs):
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        getattr(tops, name)(**kwargs)


def test_io_entry_points_raise_without_gpu(no_gpu):
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tio.BatchPrefetcher([np.zeros((1, 2, 2, 3), np.uint8)])
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tio.image_pipeline([np.zeros((1, 2, 2, 3), np.float32)], (2, 2),
                           0.1, 128)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tio.import_tflite(ROOT / "assets" / "squeezenet_v11_int8.tflite")


def test_builder_model_and_server_raise_without_gpu(no_gpu):
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tm.build_mobilenet_v2(np.random.default_rng(0), input_size=32)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tm.MobileNetV2.build(0)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        InferenceServer(lambda x: x, (2,))
    assert resolve_device("cpu") == torch.device("cpu")


def test_cpu_forward_launches_no_kernel():
    model = tm.MobileNetV2.build(
        1, device="cpu", input_size=32, num_classes=10,
        cfg=[(1, 8, 1, 1), (6, 16, 2, 2), (6, 16, 1, 1)], stem_channels=8,
        head_channels=32)
    tkernels.reset_launch_counts()
    y = model(torch.zeros(2, 32, 32, 3, dtype=torch.uint8))
    assert tuple(y.shape) == (2, 10)
    assert tkernels.launch_counts() == {
        "q8gemm": 0, "q8dwconv": 0, "q8vadd": 0, "q8gavgpool": 0,
        "q8conv": 0, "q8stem": 0, "u8maxpool": 0, "q8avgpool": 0,
        "q8bmm": 0, "u8rmax": 0, "u8lut32norm": 0, "u8clamp": 0,
        "q8gemm_partial": 0, "q8conv_partial": 0, "q8requant": 0,
        "q8gemm_grouped": 0, "q8bmm_masked": 0, "u8softmax_masked": 0,
        "q8rope": 0, "q8swiglu": 0, "moe_route": 0, "moe_combine": 0,
        "q8attn_masked": 0}


def test_cpu_resnet18_forward_launches_no_kernel():
    model = tgraph.GraphModel(*tzoo.resnet18(np.random.default_rng(1),
                                             num_classes=10, device="cpu"))
    tkernels.reset_launch_counts()
    y = model(torch.zeros(2, 32, 32, 3, dtype=torch.uint8))
    assert tuple(y.shape) == (2, 10)
    assert set(tkernels.launch_counts()) == set(tkernels.KERNELS)
    assert set(tkernels.launch_counts().values()) == {0}


def test_check_cuda_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        _build.check_cuda("a", torch.zeros(2, 2, dtype=torch.uint8),
                          torch.uint8, 2)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.find_nvcc()


def test_library_name_follows_the_sources(monkeypatch, tmp_path):
    for src in _build.CSRC.iterdir():
        shutil.copy(src, tmp_path / src.name)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path()
    assert before == _build.library_path()
    with open(tmp_path / "requant.cuh", "a") as f:
        f.write("\n")
    assert _build.library_path() != before
    assert before.parent == _build.BUILD_DIR


def test_four_kernels_with_no_library_calls():
    """The seventeen kernel sources (four of the first slice, three of the
    second, q8avgpool of the third, q8bmm, u8rmax, u8lut32norm and u8clamp
    of the fourth, q8requant of the parallel layer, q8rope, q8swiglu,
    moe_route and moe_combine of MiMo-V2-Flash's block) and their shared
    headers (the tensor-core tile of q8gemm, q8conv and q8stem, q8gemm's
    wgmma tile, the requantization, the row mapping of u8rmax and
    u8lut32norm, the window mapping of u8maxpool and q8avgpool) call no
    library; the wgmma tile includes the driver's header cuda.h for its
    TMA descriptors only.  The kernels' registry also names the partial
    instances of q8gemm.cu and q8conv.cu, q8gemm.cu's grouped instance,
    q8bmm.cu's masked instances and its fused masked attention, and
    u8lut32norm.cu's u8softmax_masked, whose wrappers count their own
    launches."""
    names = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    assert names == ["moe_combine.cu", "moe_route.cu", "q8avgpool.cu",
                     "q8bmm.cu", "q8conv.cu", "q8dwconv.cu",
                     "q8gavgpool.cu", "q8gemm.cu", "q8requant.cu",
                     "q8rope.cu", "q8stem.cu", "q8swiglu.cu", "q8vadd.cu",
                     "u8clamp.cu", "u8lut32norm.cu", "u8maxpool.cu",
                     "u8rmax.cu"]
    assert sorted(p.name for p in _build.CSRC.glob("*.cuh")) == \
        ["device_guard.cuh", "imma_tile.cuh", "pool_tile.cuh",
         "requant.cuh", "u8rows.cuh", "wgmma_tile.cuh"]
    for p in _build.CSRC.iterdir():
        text = p.read_text()
        for lib in ("cublas", "cudnn", "cutlass", "_int_mm"):
            assert lib not in text.lower(), f"{p.name} mentions {lib}"
        includes = set(re.findall(r"#include [<\"]([^>\"]+)", text))
        assert includes <= {"cuda_runtime.h", "cstdint", "requant.cuh",
                            "imma_tile.cuh", "u8rows.cuh",
                            "pool_tile.cuh", "device_guard.cuh",
                            "wgmma_tile.cuh", "cuda.h"}, \
            f"{p.name} includes {includes}"
    assert set(tkernels.KERNELS) == {n[:-3] for n in names} | {
        "q8gemm_partial", "q8conv_partial", "q8gemm_grouped", "q8bmm_masked",
        "u8softmax_masked", "q8attn_masked"}
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
    assert "-fmad=false" in _build.NVCC_FLAGS


_CTYPE = {"void*": "c_void_p", "int": "c_int", "int64_t": "c_long",
          "float": "c_float"}


def c_entry_points():
    found = {}
    for src in _build.CSRC.glob("*.cu"):
        text = src.read_text()
        for name, args in re.findall(
                r'extern "C" int (qnn_\w+)\(([^)]*)\)', text):
            types = []
            for arg in args.split(","):
                arg = " ".join(arg.replace("const", "").split())
                typ = arg.rsplit(" ", 1)[0].replace(" *", "*")
                types.append(_CTYPE[typ])
            found[name] = types
    return found


def c_entry_bodies():
    """{name: body} of every extern "C" int qnn_* entry in csrc/*.cu."""
    bodies = {}
    for src in _build.CSRC.glob("*.cu"):
        text = src.read_text()
        for m in re.finditer(r'extern "C" int (qnn_\w+)\([^)]*\)\s*\{',
                             text):
            depth, i = 1, m.end()
            while depth:
                depth += {"{": 1, "}": -1}.get(text[i], 0)
                i += 1
            bodies[m.group(1)] = text[m.end():i - 1]
    return bodies


def test_c_entries_restore_the_callers_device():
    """No entry calls cudaSetDevice itself: each opens with a
    qnn::DeviceGuard (csrc/device_guard.cuh), whose destructor restores the
    caller's device on every return path, and returns its error first."""
    bodies = c_entry_bodies()
    assert set(bodies) == set(_build.SIGNATURES)
    assert {"qnn_q8requant", "qnn_q8gemm_partial",
            "qnn_q8conv_partial"} <= set(bodies)
    for name, body in bodies.items():
        assert "cudaSetDevice" not in body, name
        lines = [ln.strip() for ln in body.strip().splitlines()]
        assert lines[0] == "const qnn::DeviceGuard guard(device);", name
        assert lines[1] == "if (guard.error() != cudaSuccess) {", name
        assert body.count("DeviceGuard") == 1, name
    guard = (_build.CSRC / "device_guard.cuh").read_text()
    assert guard.count("cudaSetDevice(") == 2
    assert "cudaGetDevice(&saved_)" in guard
    assert "~DeviceGuard() {\n    if (switched_) cudaSetDevice(saved_);" \
        in guard


def test_ctypes_signatures_match_the_c_entry_points():
    found = c_entry_points()
    assert set(found) == set(_build.SIGNATURES)
    for name, argtypes in _build.SIGNATURES.items():
        got = [t.__name__ for t in argtypes]
        got = ["c_long" if t == "c_longlong" else t for t in got]
        assert got == found[name], name


def test_scheme_codes_match_requant_header():
    header = (_build.CSRC / "requant.cuh").read_text()
    codes = {k: int(v) for k, v in re.findall(r"k(\w+) = (\d+)", header)}
    cases = {
        "Q31": make_requant_params("q31", 0.3, 1),
        "FP32": make_requant_params("fp32", 0.3, 1),
        "Precise": make_requant_params("precise", 0.3, 1),
        "Gemmlowp": make_requant_params("gemmlowp", 0.3, 1),
    }
    for key, rp in cases.items():
        assert _build.requant_args(rp, 4, "cpu")[1][0] == codes[key]
    pc = tparams.compute_per_channel_fp32_params([0.1, 0.2], 3)
    scales, args = _build.requant_args(pc, 2, "cpu")
    assert args[0] == codes["FP32PerChannel"]
    assert scales.dtype == torch.float32 and scales.tolist() == \
        [np.float32(0.1), np.float32(0.2)]
    with pytest.raises(ValueError):
        _build.requant_args(pc, 3, "cpu")


def test_q31_bounds_are_passed_absolute():
    rp = make_requant_params("q31", 0.3, 100, 20, 230)
    _, args = _build.requant_args(rp, 1, "cpu")
    assert args[:6] == [0, rp.multiplier, rp.shift, 100, 20, 230]


def run_chip_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_the_repository(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = run_chip_smoke(tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_fails_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py runs for real")
    res = run_chip_smoke(ROOT)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
