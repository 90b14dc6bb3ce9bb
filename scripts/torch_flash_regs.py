"""The flash kernels' registers and spills, this tree against another.

    python3 scripts/torch_flash_regs.py --root DIR [--out FILE]

Compiles ``ops/csrc/flash_attention.cu`` and ``flash_attention_tc.cu``
of this checkout and of the tree unpacked at DIR, each with the flags
``ops/_build.py`` builds the kernel library with plus ``-Xptxas -v``
(four ``nvcc`` processes at once), and prints, for every flash kernel
instantiation of DIR's tree, its registers and spilled bytes beside the
same instantiation here, and then the instantiations only this tree
has.  The f32 kernels of a tree before the head-dim template parameters
(kT, kDm) match this tree's (64, 128) instantiations, the tiling they
had.  Writes the rows to ``--out`` as JSON.  Needs ``nvcc``, not a card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _HERE)

from chip_smoke import ptxas_usage  # noqa: E402
from distributed_tensorflow_example_tpu_torch.ops import _build  # noqa: E402

SOURCES = ("flash_attention.cu", "flash_attention_tc.cu")
# a kernel's name and template arguments inside its mangled name
KERNEL = re.compile(r"(flash_(?:fwd|dq|dkv)_\w*?kernelI(?:L[^E]+E)+E)")
F32 = re.compile(r"^(flash_(?:fwd|dq|dkv)_kernelI)(?!Li)")


def usage(root: str, tmp: str) -> dict:
    """{kernel: {"regs", "spill_stores", "spill_loads"}} of ``root``'s
    two flash sources."""
    csrc = os.path.join(root, "distributed_tensorflow_example_tpu_torch",
                        "ops", "csrc")
    procs = []
    objs = tempfile.mkdtemp(dir=tmp)
    for src in SOURCES:
        obj = os.path.join(objs, src + ".o")
        cmd = [_build.nvcc(), *_build.ARCH_FLAGS, *_build.NVCC_FLAGS,
               "-Xptxas", "-v", "-c", os.path.join(csrc, src), "-o", obj]
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    out = {}
    for src, p in zip(SOURCES, procs):
        text, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {root}/{src}:\n{text}")
        for name, use in ptxas_usage(text).items():
            m = KERNEL.search(name)
            if m and "regs" in use:
                out[m.group(1)] = use
    return out


def _spill(use: dict) -> int:
    return use.get("spill_stores", 0) + use.get("spill_loads", 0)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True,
                    help="the other tree (an unpacked checkout)")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        theirs = usage(os.path.abspath(args.root), tmp)
        ours = usage(_HERE, tmp)
    rows = []
    for name, use in sorted(theirs.items()):
        here = F32.sub(r"\1Li64ELi128E", name)
        mine = ours.get(here)
        rows.append(dict(kernel=here, other=use, here=mine,
                         same=mine is not None
                         and (mine["regs"], _spill(mine))
                         == (use["regs"], _spill(use))))
    matched = {r["kernel"] for r in rows}
    rows += [dict(kernel=name, other=None, here=use, same=None)
             for name, use in sorted(ours.items()) if name not in matched]
    for r in rows:
        cols = [f"{r[k]['regs']} registers, {_spill(r[k])} B spilled"
                if r[k] else "absent" for k in ("other", "here")]
        verdict = {True: "same", False: "DIFFERS", None: "new"}[r["same"]]
        print(f"{r['kernel']}: {args.root} {cols[0]}; here {cols[1]} "
              f"({verdict})", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
