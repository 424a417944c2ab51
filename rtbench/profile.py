"""The reduction of a profiled sub-window's trace (torch.profiler's Chrome
trace) to what the per-layer metrics and the breakdown read: the device's
events inside the window, their union (busy time), the idle gaps and what
the host was doing in each.

The window runs from the start of the first call's `rtbench.call` span to
the end of the last one's (each call ends in a synchronize, so its device
work ends inside its span). A trace of CUDA activity alone, which records
no spans and slows the host far less, runs from its first CUDA runtime
call to the end of its last synchronize.
"""

from __future__ import annotations

import json

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")
CALL_SPAN = "rtbench.call"
# what PyTorch itself launches: its ATen kernels, cub and thrust; copies
# and fills are matched by category
LIBRARY_MARKS = ("at::", "at_cuda_detail", "cub::", "thrust::", "c10::")


def base_name(name: str) -> str:
    """A kernel's name without `void`, an anonymous namespace, arguments and
    template arguments."""
    if name.startswith("void "):
        name = name[5:]
    name = name.replace("(anonymous namespace)::", "")
    for stop in ("(", "<"):
        cut = name.find(stop)
        if cut > 0:
            name = name[:cut]
    return name.strip()


def is_library(cat: str, name: str) -> bool:
    return cat != "kernel" or any(m in name for m in LIBRARY_MARKS)


class Profile:
    """A trace's window, device events and host events (seconds)."""

    def __init__(self, events: list):
        calls = [e for e in events if e.get("ph") == "X"
                 and e.get("cat") == "user_annotation"
                 and e.get("name", "").startswith(CALL_SPAN)]
        runtime = [e for e in events if e.get("ph") == "X"
                   and e.get("cat") == "cuda_runtime"]
        syncs = [e for e in runtime if "Synchronize" in e.get("name", "")]
        if calls:
            self.t0 = min(e["ts"] for e in calls) * 1e-6
            self.t1 = max(e["ts"] + e["dur"] for e in calls) * 1e-6
        elif syncs:
            self.t0 = min(e["ts"] for e in runtime) * 1e-6
            self.t1 = max(e["ts"] + e["dur"] for e in syncs) * 1e-6
        else:
            raise ValueError("the trace holds no rtbench.call span and no "
                             "synchronize")
        self.device = []    # (base name, category, start, end), clipped
        for e in events:
            if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
                continue
            s, t = e["ts"] * 1e-6, (e["ts"] + e.get("dur", 0)) * 1e-6
            s, t = max(s, self.t0), min(t, self.t1)
            if t > s:
                self.device.append((base_name(e["name"]), e["cat"], s, t))
        host = sorted(((e["ts"] * 1e-6, (e["ts"] + e.get("dur", 0)) * 1e-6,
                        e["name"]) for e in events
                       if e.get("ph") == "X" and e.get("cat") in HOST_CATS
                       and not e.get("name", "").startswith(CALL_SPAN)))
        self.host_names = [h[2] for h in host]
        self.host_start = np.array([h[0] for h in host])
        self.host_end = np.array([h[1] for h in host])
        # by end, ties outermost (earliest start) last
        self.by_end = np.lexsort((-self.host_start, self.host_end))
        self.ends_sorted = self.host_end[self.by_end]

    @classmethod
    def load(cls, path: str) -> "Profile":
        with open(path) as f:
            return cls(json.load(f)["traceEvents"])

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy(self) -> list:
        """The union of the device's busy intervals, merged, in order."""
        out = []
        for s, t in sorted((s, t) for _, _, s, t in self.device):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t)
            else:
                out.append([s, t])
        return out

    @property
    def busy_s(self) -> float:
        return sum(t - s for s, t in self.busy())

    def gaps(self) -> list:
        """The idle intervals of the window: (start, end)."""
        out, at = [], self.t0
        for s, t in self.busy():
            if s > at:
                out.append((at, s))
            at = max(at, t)
        if self.t1 > at:
            out.append((at, self.t1))
        return out

    def host_label(self, s: float, t: float, reach: int = 256) -> str:
        """What the host was doing in the idle gap (s, t): the innermost host
        operation running at its middle (of the `reach` that started last
        before it), else the outermost one that ended last before the gap
        (`after ...`)."""
        mid = 0.5 * (s + t)
        k = int(np.searchsorted(self.host_start, mid, side="right"))
        lo = max(0, k - reach)
        cover = np.nonzero(self.host_end[lo:k] >= mid)[0]
        if len(cover):
            return self.host_names[lo + int(cover[-1])]
        j = int(np.searchsorted(self.ends_sorted, s, side="right")) - 1
        if j >= 0:
            return "after " + self.host_names[int(self.by_end[j])]
        return "host (before the first operation)"

    def device_ops(self, top: int = 10) -> list:
        """[[name, seconds]] of the device operations that took most time."""
        tot: dict = {}
        for name, cat, s, t in self.device:
            key = name if cat == "kernel" else name.split(" (")[0]
            tot[key] = tot.get(key, 0.0) + (t - s)
        return [[k, v] for k, v in sorted(tot.items(),
                                          key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """[[what the host was doing, seconds]]: the idle time of the window
        by the host's activity, the largest first."""
        tot: dict = {}
        for s, t in self.gaps():
            label = self.host_label(s, t)
            tot[label] = tot.get(label, 0.0) + (t - s)
        return [[k, v] for k, v in sorted(tot.items(),
                                          key=lambda kv: -kv[1])[:top]]

    def kernel_seconds(self, name: str) -> tuple:
        """(calls, device seconds) of the kernel with base name `name`."""
        spans = [t - s for n, c, s, t in self.device
                 if c == "kernel" and n == name]
        return len(spans), sum(spans)

    def library_seconds(self) -> float:
        """Device seconds not spent in the program's own kernels."""
        return sum(t - s for n, c, s, t in self.device if is_library(c, n))
