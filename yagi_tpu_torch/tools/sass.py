"""The machine code (SASS) of one of the port's kernel sources, to read a
loop's dependent chain from: ``nvcc -cubin`` with the build's target and
optimisation, then ``cuobjdump -sass``, on a machine with the CUDA toolkit::

    python -m yagi_tpu_torch.tools.sass agc.cu --out build/agc.sass

``source`` is a file name under ``yagi_tpu_torch/csrc`` or a path. Prints
the instruction count of each kernel in it and writes the listing to
``--out``.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import tempfile
from pathlib import Path

from ..kernels import _build


def dump(source: Path) -> str:
    nvcc = Path(_build._nvcc())
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v", "-Xcompiler", "-fPIC")]
    with tempfile.TemporaryDirectory() as tmp:
        cubin = Path(tmp) / "kernel.cubin"
        subprocess.run([str(nvcc), *flags, "-I", str(_build._CSRC), "-cubin", "-o", str(cubin),
                        str(source)], check=True)
        return subprocess.run([str(nvcc.with_name("cuobjdump")), "-sass", str(cubin)],
                              capture_output=True, text=True, check=True).stdout


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("source")
    parser.add_argument("--out", required=True)
    args = parser.parse_args(argv)
    source = Path(args.source)
    if not source.exists():
        source = _build._CSRC / args.source
    listing = dump(source)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(listing)
    for part in listing.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        print(f"[sass] {name}: {len(re.findall(r'/\*[0-9a-f]{4}\*/', part))} instructions")


if __name__ == "__main__":
    main()
