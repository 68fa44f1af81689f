"""What a traced window did on the device, read from ``torch.profiler``.

``Trace.record(fn)`` runs ``fn`` under the profiler (the CUDA activity:
the device's kernels, copies and sets, and the host's calls into the CUDA
runtime), writes the Chrome trace to a temporary file, reads it back and
deletes it. The reading keeps:

* ``device``: every device activity as (name, start us, duration us,
  category);
* ``host``: the host's runtime calls as (name, start us, duration us).

From these: the device time by name, the busy time (the union of the device
activities), and the idle gaps between them with what the host was doing
then ("host, no op" where it was in no runtime call: Python and the host's
own operators). The host's operators are not recorded: on the time-to-target
loop they cost a fifth more host time per solve than the runtime calls alone
and so read the device idler than it is. Device time comes from the trace
only: a window in which the profiler recorded no device activity raises, it
never reads as zero.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")


class Trace:
    def __init__(self):
        self.device = []
        self.host = []
        self.window_s = 0.0

    def record(self, fn):
        """Run ``fn()`` traced; returns its result. ``window_s`` is the
        host clock's length of the call, which ends in a synchronise."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            self.window_s = time.perf_counter() - t0
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                self._read(json.load(f))
        finally:
            os.remove(path)
        return out

    def _read(self, doc) -> None:
        events = doc["traceEvents"] if isinstance(doc, dict) else doc
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = e.get("cat", "")
            row = (e.get("name", ""), float(e["ts"]), float(e["dur"]))
            if cat in DEVICE_CATS:
                self.device.append(row + (cat,))
            elif cat in HOST_CATS:
                self.host.append(row)
        if not self.device:
            raise RuntimeError("the profiler recorded no device activity in "
                               "the traced window")
        self.device.sort(key=lambda x: x[1])
        self.host.sort(key=lambda x: x[1])

    # -- readings -----------------------------------------------------------

    def kernels(self, pattern: str = "") -> list:
        """Kernels whose name holds ``pattern``: (name, start, dur) in us."""
        return [d[:3] for d in self.device
                if d[3] == "kernel" and pattern in d[0]]

    def device_seconds(self, pattern: str = "") -> float:
        return sum(d[2] for d in self.kernels(pattern)) * 1e-6

    def by_name(self) -> dict:
        """Device seconds by activity name, copies and sets included."""
        out = defaultdict(float)
        for name, _, dur, _ in self.device:
            out[name] += dur * 1e-6
        return dict(out)

    def _intervals(self) -> list:
        """The device activities merged into disjoint [start, end] us."""
        merged = []
        for _, ts, dur, _ in self.device:
            end = ts + dur
            if merged and ts <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([ts, end])
        return merged

    def busy_s(self) -> float:
        return sum(b - a for a, b in self._intervals()) * 1e-6

    def idle_gaps(self) -> list:
        """(start us, length us) of every gap between device activities."""
        iv = self._intervals()
        return [(iv[i][1], iv[i + 1][0] - iv[i][1]) for i in range(len(iv) - 1)
                if iv[i + 1][0] > iv[i][1]]

    def idle_by_host(self) -> dict:
        """Idle device seconds by what the host was doing in the middle of
        each gap: the runtime call it was in (the innermost, where calls
        nest), or "host, no op"."""
        out = defaultdict(float)
        active, i = [], 0
        for start, length in self.idle_gaps():
            t = start + 0.5 * length
            while i < len(self.host) and self.host[i][1] <= t:
                active.append(self.host[i])
                i += 1
            active = [h for h in active if h[1] + h[2] > t]
            if active:
                outer = max(active, key=lambda h: h[2])[0]
                inner = min(active, key=lambda h: h[2])[0]
                what = outer if outer == inner else f"{outer} > {inner}"
            else:
                what = "host, no op"
            out[what] += length * 1e-6
        return dict(out)

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.by_name().items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_by_host().items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}
