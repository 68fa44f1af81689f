"""The design parts of K5's and K7's cluster kernels, each replaced by its
alternative or left out, timed against the kernels as built and K1, in
turns on one GPU.

    python -m spinglass_tpu_torch.benchmarks.variant_parts

Builds K5 (``csrc/metropolis_pipelined.cu``) and K7
(``csrc/metropolis_folded.cu``) as they are and with textual edits
(``K5_PARTS``, ``K7_PARTS``) into ``build/parts/<kernel>-<part>-<hash>/``
(the hash covers the edited source, the ``csrc/`` headers and the nvcc
flags, as ``kernels/build.py``'s library paths do), one nvcc per build,
all at once, and times each build through ``FusedSweep``
(the wrapper's planes and tile) on the SK glass at N=4096, R=1024, beta = 1,
Philox mode, blocks 128 and 256: CUDA events around 20 sweeps, in two rounds
(forward, then backward), K1 first and last in each. A part that replaces a
design by its alternative must make K1's decisions ("same": one +-J sweep
at 4096 x 1024 bitwise equal to K1's); a part that leaves work out
("timing only") says how much of the time that work takes. An edit that
does not match the source exactly once stops the script before any
build starts. Prints one line
per build, block and round and, last, one JSON object of the times in
microseconds per sweep.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

_DRAW = ("    draw_states<B, RULE>(spins, u, mask, i0, lane, col, live, R, "
         "k0, k1, nib,\n                         s, th);\n")
_H_READ = ("    sgt::block_barrier();\n#pragma unroll\n"
           "    for (int c = 0; c < NC; ++c)")
K5_PARTS = {
    "as built": [],
    # the decision warps' thresholds drawn while the field warps reduce
    # (and repair), before the block's barrier, not beside the fields
    "thresholds beside the reduction": [(_DRAW, ""),
                                        (_H_READ, _DRAW + _H_READ)],
    "no decisions (timing only)": [
        ("    for (int q = 0; q < RS; ++q) {",
         "    for (int q = 0; q < 0; ++q) {")],
    "no fields of the next block (timing only)": [
        ("      if (b + 1 < nb)\n        SGT_CLUSTER_FIELD_PARTIALS",
         "      if (false)\n        SGT_CLUSTER_FIELD_PARTIALS")],
}
K7_PARTS = {
    "as built": [],
    "no decisions (timing only)": [
        ("        if (lane < CPB)\n          decide_micro(",
         "        if (lane < 0)\n          decide_micro(")],
    "no corrections inside a micro-block (timing only)": [
        ("for (int q = (i + 1) / 4; q < C / 4; ++q) {",
         "for (int q = C / 4; q < C / 4; ++q) {")],
    "no delayed update (timing only)": [
        ("        delayed_update<B, PLANES>(a, C * m, warp, lane, ds_w, "
         "h_blk);\n", "")],
}


def part_source(name: str, part: str, edits) -> tuple:
    """csrc/ copied with ``edits`` applied to ``<name>.cu`` into
    ``build/parts/<name>-<part>-<hash>/csrc``, the hash over the edited
    source, every ``csrc/`` header and the nvcc flags; returns (source,
    library path)."""
    from spinglass_tpu_torch.kernels import build

    texts = {}
    for fname in sorted(os.listdir(build.CSRC_DIR)):
        with open(os.path.join(build.CSRC_DIR, fname)) as f:
            texts[fname] = f.read()
    text = texts[f"{name}.cu"]
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"{part}: {old[:60]!r} is not in {name}.cu once")
        text = text.replace(old, new)
    texts[f"{name}.cu"] = text
    digest = hashlib.sha256(" ".join(build.NVCC_FLAGS).encode())
    for fname, text in texts.items():
        if fname == f"{name}.cu" or fname.endswith(".cuh"):
            digest.update(fname.encode() + b"\0" + text.encode())
    tag = "".join(ch if ch.isalnum() else "_" for ch in part)
    root = os.path.join(build.BUILD_DIR, "parts",
                        f"{name}-{tag}-{digest.hexdigest()[:16]}")
    csrc = os.path.join(root, "csrc")
    os.makedirs(csrc, exist_ok=True)
    for fname, text in texts.items():
        with open(os.path.join(csrc, fname), "w") as f:
            f.write(text)
    return os.path.join(csrc, f"{name}.cu"), os.path.join(root, f"{name}.so")


def build_parts(parts_by_kernel: dict) -> dict:
    """Every part's library, one nvcc per missing one, all started together
    once every edit has matched: {(kernel, part): library path}."""
    from spinglass_tpu_torch.kernels import build

    out = {(name, part): part_source(name, part, edits)
           for name, parts in parts_by_kernel.items()
           for part, edits in parts.items()}
    jobs = []
    for (name, part), (src, lib) in out.items():
        if not os.path.exists(lib):
            cmd = build.nvcc_command(src, lib, build.nvcc_path())
            jobs.append((name, part, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
    for name, part, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} ({part}):\n"
                               f"{err[-3000:]}")
    return {key: lib for key, (_, lib) in out.items()}


def main() -> int:
    import ctypes

    import numpy as np
    import torch

    from spinglass_tpu_torch.benchmarks.headline import device_description
    from spinglass_tpu_torch.core import topology
    from spinglass_tpu_torch.core.problem import IsingProblem, random_spins
    from spinglass_tpu_torch.kernels import metropolis_cuda as mc

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = device_description()
    flags = {mc.PIPELINED_KERNEL: dict(pipelined=True),
             mc.FOLDED_KERNEL: dict(folded=True)}
    paths = build_parts({mc.PIPELINED_KERNEL: K5_PARTS,
                         mc.FOLDED_KERNEL: K7_PARTS})
    libs = {}
    for (name, part), path in paths.items():
        bound = mc.load_kernel(name)  # the committed build's signatures
        lib = ctypes.CDLL(path)
        fn = f"sgt_{name}"
        getattr(lib, fn).argtypes = getattr(bound, fn).argtypes
        getattr(lib, fn).restype = ctypes.c_int
        lib.sgt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.sgt_cuda_error_string.restype = ctypes.c_char_p
        libs[(name, part)] = lib

    sk = IsingProblem.from_dense(topology.fully_connected(
        4096, dist="gaussian", scale=1.0 / 64, seed=42), device="cuda")
    j = topology.fully_connected(4096, dist="binary", seed=5)
    h = np.random.default_rng(5).integers(-8, 9, 4096) / 4.0
    pm = IsingProblem.from_dense(j, h, device="cuda")
    gen = torch.Generator().manual_seed(5)
    s0 = random_spins(gen, (1024, 4096), sk.active_mask).t().contiguous()
    beta = torch.ones(1024, device="cuda")
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))

    def sweep(problem, block, key):
        if key == "K1":
            return mc.FusedSweep(problem, block_size=block)
        fused = mc.FusedSweep(problem, block_size=block, **flags[key[0]])
        fused._lib = libs[key]
        return fused

    def us_per_sweep(fused):
        s = s0.clone()
        fused(s, beta, 1)
        start.record()
        for k in range(20):
            fused(s, beta, 2 + k)
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) * 1e3 / 20

    times: dict = {}
    keys = ["K1"] + list(libs) + ["K1"]
    for block in (128, 256):
        same = {}
        b_pm = torch.full((1024,), 0.05, device="cuda")
        ref = s0.clone()
        mc.FusedSweep(pm, block_size=block)(ref, b_pm, 99)
        for key in libs:
            if "timing only" not in key[1]:
                got = s0.clone()
                sweep(pm, block, key)(got, b_pm, 99)
                same[key] = torch.equal(got, ref)
        for rnd, order in enumerate((1, -1)):
            for key in keys[::order]:
                us = us_per_sweep(sweep(sk, block, key))
                label = key if key == "K1" else f"{key[0]} {key[1]}"
                times.setdefault(f"{label} B={block}", []).append(us)
                note = ("" if key not in same else
                        ", same as K1 on +-J" if same[key] else
                        ", DIFFERS from K1 on +-J")
                print(f"{label} 4096x1024 B={block} (round {rnd}): "
                      f"{us:.1f} us{note} [{card}]", flush=True)
        if not all(same.values()):
            print("a replacing part differs from K1", file=sys.stderr)
            return 1
    print(json.dumps({"card": card, "us": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
