"""Tests of the benchmark harness. They run on the CPU at tiny sizes; a
test that needs the card carries the `cuda` marker and takes the
`cuda_device` fixture, which skips where there is none.

    python -m pytest rtbench/tests -q
"""

import json
import os
import shutil

import pytest

RTBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: the test needs a CUDA card")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda", 0)


def tiny_copy(dest, width=48, height=27, pixels=300, frames_per_view=1):
    """A copy of rtbench's data with every frame cut to width x height, each
    view one frame (so every capture call is the dump call), traced
    sub-windows of one call and one sampled call a door. Returns its
    root."""
    root = os.path.join(str(dest), "rtbench")
    shutil.copytree(RTBENCH, root, ignore=shutil.ignore_patterns(
        "out", "__pycache__", "tests"))
    for name in os.listdir(os.path.join(root, "configs")):
        path = os.path.join(root, "configs", name)
        with open(path) as f:
            cfg = json.load(f)
        cfg["width"], cfg["height"] = width, height
        with open(path, "w") as f:
            json.dump(cfg, f)
    for name in os.listdir(os.path.join(root, "traffic")):
        if not name.endswith(".json"):
            continue
        path = os.path.join(root, "traffic", name)
        with open(path) as f:
            tr = json.load(f)
        tr.update(frames_per_view=frames_per_view, trace_calls=1)
        tr["sample"] = {"calls": 1, "pixels": pixels}
        with open(path, "w") as f:
            json.dump(tr, f)
    return root


@pytest.fixture
def tiny_root(tmp_path, monkeypatch):
    """A tiny copy (`tiny_copy`), its runs warmed up by one call a door."""
    from rtbench.traffic import generator

    monkeypatch.setattr(generator, "WARMUP_PER_DOOR", 1)
    return tiny_copy(tmp_path)
