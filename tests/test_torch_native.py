"""The native runtime's binding in the port (tpuserve_torch/bindings/native.py)
against the JAX package's (tpuserve/bindings/native.py, which imports only
ctypes), both over one libtpuserve.so built here from native/ with cmake and
ninja into a temporary directory (TPUSERVE_NATIVE_LIB names it):

- the library's version; the repository scan, latest_version, has_model
  and model_type over a temporary repository laid out like models/;
  lifecycle transitions and stats; the page allocator's ensure / release /
  page_table / free_pages over a seeded sequence, also against the port's
  `_PyKvAllocator` (the two place pages alike);
- the port's ModelRepository on the native scan lists what the Python walk
  lists (TPUSERVE_NATIVE=0);
- a CPU paged engine on the native allocator serves the greedy tokens it
  serves on `_PyKvAllocator`, a prefix hit included.

Both packages' loader caches are reset around every test, so that no other
test in the process sees the library.
"""

import os
import shutil
import subprocess
import time

import numpy as np
import pytest

from tpuserve.bindings import native as jnative
from tpuserve_torch.bindings import native as tnative
from tpuserve_torch.serving import paged_kv as tpkv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reset_loaders():
    tnative.reset()
    jnative._LIB, jnative._LIB_TRIED = None, False


@pytest.fixture(scope="module")
def native_lib(tmp_path_factory):
    """libtpuserve.so built from native/ (the library target only)."""
    if not (shutil.which("cmake") and shutil.which("ninja")):
        pytest.fail("cmake and ninja are needed to build native/")
    build = tmp_path_factory.mktemp("native_build")
    for cmd in (["cmake", "-S", os.path.join(REPO, "native"), "-B", str(build), "-G", "Ninja"],
                ["ninja", "-C", str(build), "tpuserve"]):
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    lib = build / "libtpuserve.so"
    assert lib.exists()
    return str(lib)


@pytest.fixture()
def loaded(native_lib, monkeypatch):
    monkeypatch.setenv("TPUSERVE_NATIVE_LIB", native_lib)
    monkeypatch.delenv("TPUSERVE_NATIVE", raising=False)
    _reset_loaders()
    yield native_lib
    _reset_loaders()


def test_version_matches(loaded):
    assert tnative.available() and jnative.available()
    assert tnative.version() == jnative.version()
    assert tnative.version()


def _repo_tree(root):
    """A repository laid out like models/: numeric and named versions, each
    kind of marker file, a config-only version and directories that hold
    no model."""
    layout = {
        "llm_demo/1/config.json": "{}", "llm_demo/2/config.json": "{}",
        "llm_demo/10/model.safetensors": "", "bert/1/model.safetensors": "",
        "onnx_model/3/model.onnx": "", "ts_model/1/model.pt": "",
        "trt/1/model.plan": "", "tf/1/saved_model.pb": "", "named/beta/config.json": "{}",
        "named/alpha/params.msgpack": "", "empty/1/README": "", "loose.txt": "",
    }
    for rel, body in layout.items():
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as fh:
            fh.write(body)
    os.makedirs(os.path.join(root, "novers"), exist_ok=True)
    return root


def test_repository_scan_matches(loaded, tmp_path):
    root = _repo_tree(str(tmp_path))
    t, j = tnative.NativeRepository(root), jnative.NativeRepository(root)
    assert t.scan() == j.scan()
    assert set(t.scan()) == {"llm_demo", "bert", "onnx_model", "ts_model", "trt", "tf", "named"}
    for model in ("llm_demo", "bert", "named", "missing"):
        assert t.latest_version(model) == j.latest_version(model)
        for ver in (None, "1", "2", "10", "alpha", "7"):
            assert t.has_model(model, ver) == j.has_model(model, ver)
            assert t.model_type(model, ver) == j.model_type(model, ver)
    assert t.latest_version("llm_demo") == "10"


def test_lifecycle_matches(loaded):
    t, j = tnative.NativeLifecycle(), jnative.NativeLifecycle()
    script = [("get_state", "m"), ("begin_load", "m"), ("begin_load", "m"),
              ("get_state", "m"), ("finish_load", "m", True), ("get_state", "m"),
              ("record_inference", "m", 1500), ("record_inference", "m", 2500),
              ("record_error", "m"), ("stats", "m"), ("begin_unload", "m"),
              ("begin_unload", "m"), ("finish_unload", "m"), ("get_state", "m"),
              ("begin_load", "n"), ("finish_load", "n", False), ("get_state", "n"),
              ("begin_unload", "n"), ("stats", "n"), ("finish_unload", "x")]
    for call in script:
        got = getattr(t, call[0])(*call[1:])
        want = getattr(j, call[0])(*call[1:])
        assert got == want, call
    assert t.get_state("m") == "UNLOADED" and t.get_state("n") == "ERROR"
    assert t.stats("m")["inference_count"] == 2 and t.stats("m")["error_count"] == 1


def test_allocator_matches_and_places_like_python(loaded):
    """A seeded sequence of ensure / release over 8 sequences: the port's
    native allocator, the JAX package's and the port's `_PyKvAllocator`
    answer alike at every call, page tables and free pages included."""
    allocs = [tnative.NativeKvAllocator(64, 16), jnative.NativeKvAllocator(64, 16),
              tpkv._PyKvAllocator(64, 16)]
    rng = np.random.default_rng(0)
    for step in range(400):
        seq = int(rng.integers(0, 8))
        if rng.random() < 0.25:
            outs = [a.release(seq) for a in allocs]
        else:
            n = int(rng.integers(0, 200))
            outs = [a.ensure(seq, n) for a in allocs]
        assert outs[0] == outs[1] == outs[2], (step, outs)
        tables = [a.page_table(seq) for a in allocs]
        assert tables[0] == tables[1] == tables[2], (step, tables)
        assert allocs[0].free_pages == allocs[1].free_pages == allocs[2].free_pages
    assert allocs[0].total_pages == allocs[1].total_pages == 64


def test_model_repository_native_and_python_agree(loaded, tmp_path, monkeypatch):
    from tpuserve_torch.repository.repo import ModelRepository

    root = _repo_tree(str(tmp_path))
    native = ModelRepository(root)
    assert native.uses_native
    monkeypatch.setenv("TPUSERVE_NATIVE", "0")
    python = ModelRepository(root)
    assert not python.uses_native
    assert native.scan() == python.scan()
    assert native.get_model_names() == python.get_model_names()
    for name in python.get_model_names():
        assert native.get_latest_version(name) == python.get_latest_version(name)
    monkeypatch.delenv("TPUSERVE_NATIVE")
    models = ModelRepository(os.path.join(REPO, "models"))
    assert models.uses_native
    monkeypatch.setenv("TPUSERVE_NATIVE", "0")
    assert models.scan() == ModelRepository(os.path.join(REPO, "models")).scan()


def test_paged_engine_on_native_allocator_matches_python(loaded, tmp_path, monkeypatch):
    """The paged CPU engine (prefix sharing, chunks of a page) on the native
    allocator and on `_PyKvAllocator`: the same greedy tokens, one prefix
    hit each, every page back after."""
    from tpuserve_torch.repository.config import ModelConfig
    from tpuserve_torch.serving.engine import GenerationEngine
    from torch_parity import SMALL, write_model

    cfg = {"name": "pg", "platform": "llm", "architecture": "llama",
           "model_params": dict(SMALL),
           "quantization": {"weights": "int4", "group_size": 128, "kv_cache": "int8"},
           "generation": dict(max_seq_len=64, max_slots=3, eos_token_id=-1, max_new_tokens=8,
                              prefill_chunk=16, paged=True, page_size=16,
                              prefix_sharing=True)}
    vdir = write_model(str(tmp_path), "pg", cfg)
    stem = list(range(40, 58))
    prompts = [stem + [3, 4], [5, 17, 100, 42, 7], stem + [9]]

    def serve():
        eng = GenerationEngine(vdir, ModelConfig.from_dict(cfg), device="cpu")
        eng.start()
        try:
            kind = eng.kv_allocator
            out = []
            for prm in prompts:   # one after another: the third hits the first's page
                out.append(eng.generate(prm, max_new_tokens=8)["generated_ids"])
            t_end = time.monotonic() + 30   # the last slot's pages go back on the loop
            while True:
                stats = eng.serving_stats()
                free = stats["kv_free_pages"] + stats["prefix_cached_blocks"]
                if free == eng.cache.n_pages - 1 or time.monotonic() > t_end:
                    return kind, out, stats["prefix_hits"], free, eng.cache.n_pages - 1
                time.sleep(0.01)
        finally:
            eng.stop()

    kind, out, hits, free, total = serve()
    assert kind == "NativeKvAllocator" and hits == 1 and free == total
    monkeypatch.setattr(tpkv, "make_allocator", tpkv._PyKvAllocator)
    kind_py, out_py, hits_py, free_py, _ = serve()
    assert kind_py == "_PyKvAllocator" and hits_py == 1 and free_py == total
    assert out == out_py
