"""A kernel's machine code in two checkouts, compared function by function.

    python -m spinglass_tpu_torch.benchmarks.sass_diff PARENT_DIR [NAME ...]

builds ``csrc/<NAME>.cu`` (default: ``metropolis_sweep``, K1) of this
checkout and of PARENT_DIR with the build's nvcc flags into
``build/sass/``, disassembles both libraries with ``cuobjdump -sass`` and
prints, for every kernel function, its SASS lines in each, whether they
are identical (addresses, encodings and the anonymous namespace's
per-file tag removed) and else how many lines of each the other lacks,
and ptxas's spill bytes. PARENT_DIR is another checkout unpacked inside this
one, as for ``kernel_turns.py``. Needs nvcc and cuobjdump, no GPU.
"""

from __future__ import annotations

import collections
import os
import re
import shutil
import subprocess
import sys

_FUNCTION = re.compile(r"^\s*Function\s*:\s*(\S+)")
_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_[0-9a-f]{8}")


def _name(mangled: str) -> str:
    return _ANON.sub("_GLOBAL__N_", mangled)


def sass_functions(text: str) -> dict:
    """``cuobjdump -sass`` output -> {function: [instruction lines]}, each
    line without its address and encoding comments and with its spaces
    collapsed."""
    out, cur = {}, None
    for line in text.splitlines():
        m = _FUNCTION.match(line)
        if m:
            cur = out.setdefault(_name(m.group(1)), [])
            continue
        line = re.sub(r"\s+", " ", re.sub(r"/\*[^*]*\*/", "", line)).strip()
        if cur is not None and line and line not in ("{", "}"):
            cur.append(line)
    return out


def ptxas_spills(text: str) -> dict:
    """ptxas -v output -> {function: (spill store bytes, spill load
    bytes)}."""
    out, cur = {}, None
    for line in text.splitlines():
        m = _ENTRY.search(line)
        if m:
            cur = _name(m.group(1))
        m = _SPILL.search(line)
        if m and cur is not None:
            out[cur] = (int(m.group(1)), int(m.group(2)))
    return out


def lacking(a: list, b: list) -> int:
    """Lines of ``a`` that ``b`` lacks, counted with multiplicity."""
    return sum((collections.Counter(a) - collections.Counter(b)).values())


def _build(root: str, name: str, out: str) -> subprocess.Popen:
    from spinglass_tpu_torch.kernels import build

    cmd = build.nvcc_command(os.path.join(root, "spinglass_tpu_torch", "csrc",
                                          f"{name}.cu"), out,
                             build.nvcc_path())
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def main(argv) -> int:
    from spinglass_tpu_torch.kernels import build

    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    if not argv or not os.path.isdir(os.path.join(argv[0],
                                                  "spinglass_tpu_torch")):
        print(__doc__, file=sys.stderr)
        return 2
    parent = os.path.realpath(argv[0])
    if os.path.commonpath([parent, os.path.realpath(here)]) != \
            os.path.realpath(here) or parent == os.path.realpath(here):
        print(f"PARENT_DIR must lie inside {here}", file=sys.stderr)
        return 2
    names = argv[1:] or ["metropolis_sweep"]
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    if not os.path.exists(cuobjdump):
        cuobjdump = shutil.which("cuobjdump") or "cuobjdump"
    outdir = os.path.join(build.BUILD_DIR, "sass")
    os.makedirs(outdir, exist_ok=True)
    jobs = {(name, which): (lib, _build(root, name, lib))
            for name in names
            for which, root in (("parent", parent), ("change", here))
            for lib in [os.path.join(outdir, f"{name}-{which}.so")]}
    found = {}
    for key, (lib, proc) in jobs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            print(f"nvcc failed for {key}:\n{stderr[-3000:]}", file=sys.stderr)
            return 1
        dump = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                              text=True, check=True).stdout
        found[key] = (sass_functions(dump), ptxas_spills(stdout + stderr))
    same = True
    for name in names:
        (old, old_sp), (new, new_sp) = found[(name, "parent")], \
            found[(name, "change")]
        for fn in sorted(set(old) | set(new)):
            a, b = old.get(fn, []), new.get(fn, [])
            gone, added = lacking(a, b), lacking(b, a)
            same = same and a == b
            diff = ("identical" if a == b else
                    f"the change lacks {gone}, the parent {added}")
            print(f"{name} {fn}: parent {len(a)} lines, change {len(b)}, "
                  f"{diff}; spill "
                  f"bytes (stores, loads) parent {old_sp.get(fn)}, change "
                  f"{new_sp.get(fn)}")
    print("same machine code" if same else "machine code differs")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
