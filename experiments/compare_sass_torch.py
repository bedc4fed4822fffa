#!/usr/bin/env python3
"""The machine code of this tree's CUDA kernels against another tree's.

    python3 experiments/compare_sass_torch.py OTHER_ROOT [WORK_DIR]

OTHER_ROOT is another checkout of the repository (for instance the parent
commit unpacked with ``git archive``).  Every ``csrc/*.cu`` of both trees
is compiled to an ``sm_90a`` cubin with the build's own flags
(``ops/_cuda_build.NVCC_FLAGS``, minus those of a shared library) and
disassembled with ``cuobjdump -sass``.  Each kernel of OTHER_ROOT is held
against its counterpart here, instruction by instruction: the
instruction text and both 64-bit words of its encoding, addresses
dropped.  The counterpart has the same name and template arguments, or
those arguments followed by a trailing 0: the template parameter a
kernel gained since (the coefficient count NE = 0 of the streaming
kernel against a tree before it; against a tree that has NE, the
streaming kernel's SEG = 0 and the prolongation's MODE = 0, add; the
wide kernel's and the face-plane apply's SEG = 0; the face-plane apply's
SLAB = 0).
Kernels here without a counterpart there (new variants: NE = 1 and 3,
SEG = 1, the NS = 1 half-sweep, prolongation modes 1 and 2, the boxed
solver's flat half-sweep) are listed as new.

A kernel of OTHER_ROOT that a newer design here replaced, so that the
shipped build no longer holds it, is looked up in this tree's build of
the designs before (``PROBE_FLAGS``, what
``experiments/probe_torch_kernels.py`` times the new designs against)
and listed under "probe_only" when found there.

Prints one JSON object: {"kernels": [{"name", "counterpart", "build",
"instructions", "identical", "first_difference"}], "new": [...],
"probe_only": [...], "all_identical": bool}.  Exits 1 when a kernel of
OTHER_ROOT has no counterpart in either build or differs.  Needs nvcc
and cuobjdump, no GPU.
"""
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from octree_mg_tpu_torch.ops import _cuda_build as cb  # noqa: E402

LIB_ONLY = ("-shared", "-Xcompiler", "-fPIC")
_ADDR = re.compile(r"/\*[0-9a-f]{4,}\*/")
_NAME = re.compile(r"^(?:void )?([\w:]+)(?:<(.*)>)?\(")
#: the build of the designs the shipped ones replaced: every coefficient
#: kernel (the slabs' too), every segment launch and one half-sweep on
#: stream_kernel.cuh, the slab prolongation on its thread-per-coarse-cell
#: kernel, the double-float residual as a thread per cell
PROBE_FLAGS = ["-DOMG_FACES=0", "-DOMG_SEGWIDE=0", "-DOMG_SLABAP=0",
               "-DOMG_SLABEPS=0", "-DOMG_HALFAF=0", "-DOMG_DF32MARCH=0"]


def _tool(name):
    nvcc = cb._nvcc()
    path = os.path.join(os.path.dirname(nvcc), name)
    return path if os.path.exists(path) else shutil.which(name) or name


def _flags():
    return [f for f in cb.NVCC_FLAGS if f not in LIB_ONLY]


def disassemble(root, work, extra=()):
    """{mangled kernel name: [normalised SASS lines]} of every source,
    built with the extra nvcc flags."""
    csrc = os.path.join(root, "octree_mg_tpu_torch", "csrc")
    os.makedirs(work, exist_ok=True)
    procs = {}
    for fn in sorted(os.listdir(csrc)):
        if not fn.endswith(".cu"):
            continue
        cubin = os.path.join(work, fn[:-3] + ".cubin")
        procs[fn] = (cubin, subprocess.Popen(
            [cb._nvcc(), *_flags(), *extra, "-cubin", "-I", csrc, "-o", cubin,
             os.path.join(csrc, fn)]))
    kernels = {}
    for fn, (cubin, p) in procs.items():
        if p.wait() != 0:
            raise RuntimeError(f"nvcc failed for {root}/{fn}")
        sass = subprocess.run([_tool("cuobjdump"), "-sass", cubin],
                              capture_output=True, text=True,
                              check=True).stdout
        name = None
        for line in sass.splitlines():
            s = line.strip()
            if s.startswith("Function :"):
                name = s.split(":", 1)[1].strip()
                kernels[name] = []
            elif name and s.startswith("/*"):
                kernels[name].append(" ".join(_ADDR.sub("", s).split()))
    return kernels


def demangle(names):
    out = subprocess.run([_tool("cu++filt")], input="\n".join(names),
                         capture_output=True, text=True, check=True).stdout
    return dict(zip(names, out.splitlines()))


def key(demangled):
    """(name, template arguments) of a demangled kernel signature."""
    m = _NAME.match(demangled)
    if not m:
        return demangled, ()
    args = tuple(re.sub(r"^\(int\)", "", a.strip())
                 for a in m.group(2).split(",")) if m.group(2) else ()
    return m.group(1), args


def main(argv):
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    other = os.path.abspath(argv[0])
    work = argv[1] if len(argv) > 1 else tempfile.mkdtemp(prefix="sass_")
    here = disassemble(ROOT, os.path.join(work, "here"))
    probe = disassemble(ROOT, os.path.join(work, "probe"), PROBE_FLAGS)
    there = disassemble(other, os.path.join(work, "other"))
    names = demangle(sorted(set(here) | set(probe) | set(there)))

    keys = {b: {key(names[k]): k for k in built}
            for b, built in (("shipped", here), ("probe", probe))}

    def find(b, name, args):
        return keys[b].get((name, args)) or keys[b].get((name, args + ("0",)))

    rows, used, probe_only, ok = [], set(), [], True
    for k, lines in sorted(there.items()):
        name, args = key(names[k])
        mine, built, src = find("shipped", name, args), "shipped", here
        if mine is None:
            mine, built, src = find("probe", name, args), "probe", probe
        row = {"name": names[k], "counterpart": names.get(mine),
               "build": built, "instructions": len(lines) // 2}
        if mine is None:
            row.update(identical=False, first_difference="no counterpart")
        else:
            if built == "shipped":
                used.add(mine)
            else:
                probe_only.append(names[k])
            here_lines = src[mine]
            same = here_lines == lines
            diff = next((i for i, (a, b) in enumerate(zip(here_lines, lines))
                         if a != b), min(len(here_lines), len(lines)))
            row.update(identical=same, first_difference=None if same else {
                "line": diff,
                "here": here_lines[diff] if diff < len(here_lines) else None,
                "other": lines[diff] if diff < len(lines) else None})
        ok &= row["identical"]
        rows.append(row)
    print(json.dumps({"other": other, "kernels": rows,
                      "new": sorted(names[k] for k in here if k not in used),
                      "probe_only": probe_only, "all_identical": ok}),
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
