"""The Swendsen-Wang kernels' design parts, each left out or replaced, timed
against the kernels as they stand, in turns on one GPU.

    python -m spinglass_tpu_torch.benchmarks.sw_parts

Builds C1 (``csrc/sw_labels.cu``) and C2 (``csrc/sw_bonds.cu``) as they are
and with one textual edit each (``C1_PARTS``, ``C2_PARTS``) into
``build/parts/<kernel>-<part>/``, and times every build on one SW sweep's
inputs on the TTT instance (``headline.ttt_instance``: random spins at the
TTT config's ladder's betas) at 128 and 16 replicas, Philox mode, as a CUDA graph of 20 calls (CUDA events around one
replay), in two rounds (forward, then backward). A part that replaces a
design by its simpler alternative must give the plain versions' result bit
for bit ("same"); a part that leaves work out ("timing only") does not, and
says how much of the time that work takes. An edit that does not match
the source exactly once stops the script. Prints one line per build and
round and, last, one JSON object of the times in microseconds.
"""

from __future__ import annotations

import json
import os
import sys

# C1: the union queue replaced by one lane per site; pointer halving off;
# the unions and the phase-3 finds left out (timing only)
_QUEUE_LOOP = """      while (__any_sync(0xffffffffu, m != 0u)) {"""
_LANE_LOOP = """      while (m != 0u) {
        const int q = wd * 32 + __ffs(m) - 1;
        m &= m - 1u;
        const int j = __ldg(a.idx + (size_t)i * a.k + q);
        if (j > i) unite(t, x, j + 1);
      }
      while (false) {"""
_HALVE = """      *t.at(prev) = next;
"""
_UNITE_QUEUED = "            unite(t, e.x, e.y);"
_UNITE_REST = "  if (lane < queued) unite(t, wq[lane].x, wq[lane].y);"
_FIND3 = "    const int lab = act ? find_root(t, x) - 1 : pad_label;"
C1_PARTS = {
    "as built": [],
    "one lane per site (no union queue)": [(_QUEUE_LOOP, _LANE_LOOP)],
    "no pointer halving": [(_HALVE, "")],
    "no unions (timing only)": [(_UNITE_QUEUED, "            (void)e;"),
                                (_UNITE_REST, "")],
    "no phase-3 finds (timing only)": [
        (_FIND3, "    const int lab = act ? x - 1 : pad_label;")],
}
# C2: the staged sign bytes replaced by gathers from device memory; a cache
# of each replica's last bond probability (+-J couplings repeat jss: expm1f
# only where it changes); Philox and the slot loop left out (timing only)
_PHILOX = ("            sgt::philox4x32((uint32_t)ea[e], (uint32_t)g, "
           "(uint32_t)eb[e],\n                            TAG_BOND, k0, k1, x);")
C2_PARTS = {
    "as built": [],
    "no staged signs (gathers)": [
        ("  const bool staged = n <= STAGE_MAX;",
         "  const bool staged = false;")],
    "a bond-probability cache": [
        ("  const int i_end = min(n, (blockIdx.x + 1) * THREADS * spt);",
         "  const int i_end = min(n, (blockIdx.x + 1) * THREADS * spt);\n"
         "  float last_jss[4] = {0.f, 0.f, 0.f, 0.f}, last_p[4];"),
        ("            if (((sat >> c) & 1u) && u[c] < -expm1f(b2[c] * jss))",
         "            if (((sat >> c) & 1u) && u[c] < (jss == last_jss[c] ? "
         "last_p[c] : (last_jss[c] = jss, last_p[c] = -expm1f(b2[c] * "
         "jss))))")],
    "no Philox (timing only)": [
        (_PHILOX, "            x[0] = x[1] = x[2] = x[3] = ea[e] ^ eb[e];")],
    "no slot loop (timing only)": [
        ("      const int q_end = (wd + 1) * 32 < k ? (wd + 1) * 32 : k;",
         "      const int q_end = wd * 32;")],
}


def build_part(name: str, part: str, edits) -> str:
    """csrc/ copied with ``edits`` applied to ``<name>.cu``, built into
    ``build/parts/<name>-<part>/``; returns the library's path."""
    from spinglass_tpu_torch.kernels import build

    tag = "".join(ch if ch.isalnum() else "_" for ch in part)
    root = os.path.join(build.BUILD_DIR, "parts", f"{name}-{tag}")
    csrc = os.path.join(root, "csrc")
    os.makedirs(csrc, exist_ok=True)
    for fname in os.listdir(build.CSRC_DIR):
        with open(os.path.join(build.CSRC_DIR, fname)) as f:
            text = f.read()
        if fname == f"{name}.cu":
            for old, new in edits:
                if text.count(old) != 1:
                    raise ValueError(f"{part}: {old[:60]!r} is not in "
                                     f"{fname} once")
                text = text.replace(old, new)
        with open(os.path.join(csrc, fname), "w") as f:
            f.write(text)
    out = os.path.join(root, f"{name}.so")
    if not os.path.exists(out):
        import subprocess

        cmd = build.nvcc_command(os.path.join(csrc, f"{name}.cu"), out,
                                 build.nvcc_path())
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    return out


def main() -> int:
    import ctypes
    import dataclasses

    import torch

    from spinglass_tpu_torch.anneal import pt
    from spinglass_tpu_torch.benchmarks.headline import (device_description,
                                                         ttt_config,
                                                         ttt_instance)
    from spinglass_tpu_torch.core.cluster import SwendsenWang
    from spinglass_tpu_torch.kernels import cluster_cuda as cc

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    card = device_description()
    ttt, _ = ttt_instance()
    sw = SwendsenWang(ttt)
    n, k = sw._idx.shape
    # bind each part's library as the wrappers bind theirs
    libs = {}
    for name, parts in ((cc.KERNEL_NAME, C1_PARTS),
                        (cc.BONDS_KERNEL, C2_PARTS)):
        bound = cc._load(name)   # the committed build, and its signatures
        for part, edits in parts.items():
            lib = ctypes.CDLL(build_part(name, part, edits))
            fn = f"sgt_{name}"
            getattr(lib, fn).argtypes = getattr(bound, fn).argtypes
            getattr(lib, fn).restype = ctypes.c_int
            lib.sgt_cuda_error_string.argtypes = [ctypes.c_int]
            lib.sgt_cuda_error_string.restype = ctypes.c_char_p
            libs[(name, part)] = lib
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))

    def graph_us(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        start.record()
        for _ in range(3):
            graph.replay()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) * 1e3 / 3 / reps

    times: dict = {}
    for r in (128, 16):
        gen = torch.Generator().manual_seed(r)
        s = torch.where(torch.rand(r, n, generator=gen) < 0.5, -1.0, 1.0)
        s = torch.where(sw.ell.active_mask.cpu()[None] > 0, s, 1.0)
        s = s.cuda().contiguous()
        beta = 1.0 / torch.as_tensor(pt.temperature_ladder(
            dataclasses.replace(ttt_config(), n_replicas=r)),
            dtype=torch.float32, device="cuda")
        slot = torch.tensor([7], dtype=torch.int64, device="cuda")[0]
        b = sw.bonds
        masks, init = cc.bonds_reference(b.idx, b.val, b.h, b.active,
                                         b.rev_i, b.rev_k, s, beta, seed=slot)
        labels, _ = cc.labels_reference(sw._idx, cc.unpack_masks(masks, k),
                                        init)
        spins, n_cl = cc.flip_reference(s, labels, init, seed=slot)
        for rnd, order in enumerate((1, -1)):
            for name, parts in ((cc.KERNEL_NAME, C1_PARTS),
                                (cc.BONDS_KERNEL, C2_PARTS)):
                for part in list(parts)[::order]:
                    if name == cc.KERNEL_NAME:
                        c1 = cc.ClusterLabels()
                        c1._lib = libs[(name, part)]
                        call = (lambda c1=c1: c1.flip(sw._idx, masks, init,
                                                      s, seed=slot))
                        got = call()
                        same = (torch.equal(got[0], spins)
                                and torch.equal(got[1], n_cl)
                                and torch.equal(got[2], labels))
                    else:
                        c2 = cc.BondActivation(b.idx, b.val, b.h, b.active,
                                               b.rev_i, b.rev_k)
                        c2._lib = libs[(name, part)]
                        call = (lambda c2=c2: c2(s, beta, seed=slot))
                        got = call()
                        same = (torch.equal(got[0], masks)
                                and torch.equal(got[1], init))
                    us = graph_us(call)
                    key = f"{name} [{r}, {n}] {part}"
                    times.setdefault(key, []).append(us)
                    print(f"{key} (round {rnd}): {us:.1f} us, "
                          f"{'same' if same else 'differs'} [{card}]",
                          flush=True)
    print(json.dumps({"card": card, "us": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
