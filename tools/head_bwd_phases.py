"""Clock cycles of the narrow head backward's row kernel by phase, on the
card: builds a copy of csrc/grounding_head.cu with a clock64 read at each
phase marker of ``head_bwd_rows_wg`` (the first thread of each consumer
warpgroup adds the phase's cycles into a device array), runs the backward
once at GT5 (B=16, T=200) and P100 (B=2, T=4000), A=5, D=512, Dh=256, at
"default" and "highest", and prints the mean over the blocks of each
phase's cycles for each warpgroup, summed over a block's items:

    python3 tools/head_bwd_phases.py

Phases: (1) the cross tile, (2) z0 and z1, (3) the z1 exchange and dz1,
(4) dh, (5) dcross.  The instrumented copy builds apart (a temporary
directory); the package's own libraries are untouched."""

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np  # noqa: E402
import torch  # noqa: E402

from vog_tpu_torch.kernels import _build, grounding_head as gh  # noqa: E402

MARKS = ["// (1) cross", "// (2) z0 and z1", "// (3) z1 = the two", "// (4) dh = ", "// (5) dcross"]
NAMES = ["cross", "z0+z1", "xchg+dz1", "dh", "dcross"]


def instrumented(src: str) -> str:
    for i, m in enumerate(MARKS):
        src = src.replace("    " + m, f"    VOG_PH({i});\n    " + m, 1)
    k = src.index("// (5) dcross")
    end = src.index("\n  }\n}\n", k)  # the end of the item loop
    src = src[:end] + "\n    VOG_PH(5);" + src[end:]
    head = (
        "\n__device__ unsigned long long g_ph[2048][2][6];\n"
        "#define VOG_PH(i) do { if ((threadIdx.x & 127) == 0) { unsigned long long c_ = clock64(); \\\n"
        "  if (i > 0) g_ph[blockIdx.x][threadIdx.x >> 7][i - 1] += c_ - ph0_; ph0_ = c_; } } while (0)\n")
    src = src.replace("namespace {", head + "namespace {", 1)
    src = src.replace("  int q = 0;  // the stage this warpgroup reads next",
                      "  int q = 0;  // the stage this warpgroup reads next\n  unsigned long long ph0_ = 0;", 1)
    return src + (
        '\nextern "C" int vog_ph_read(void* h) { return (int)cudaMemcpyFromSymbol(h, g_ph, sizeof(g_ph)); }\n'
        'extern "C" int vog_ph_zero() { static unsigned long long z[2048][2][6]; '
        "return (int)cudaMemcpyToSymbol(g_ph, z, sizeof(z)); }\n")


def main() -> int:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    tmp = tempfile.mkdtemp()
    for f in _build.CSRC.glob("*.cuh"):
        shutil.copy(f, tmp)
    with open(os.path.join(tmp, "grounding_head.cu"), "w") as f:
        f.write(instrumented((_build.CSRC / "grounding_head.cu").read_text()))
    _build.CSRC = type(_build.CSRC)(tmp)
    os.environ["VOG_TORCH_BUILD_DIR"] = os.path.join(tmp, "build")
    _build.LIBRARIES = tuple(x for x in _build.LIBRARIES if x[0] == "grounding_head.cu")
    _build.build_all()
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for B, T in ((16, 200), (2, 4000)):
        g = torch.Generator(device=dev)
        g.manual_seed(4)
        A, D, Dh = 5, 512, 256
        r = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
        vis, arg = torch.relu(r(B, T, D)), torch.relu(r(B, A, D))
        args = (vis, arg, vis @ (r(D, D) / D**0.5), arg @ (r(D, D) / D**0.5), r(D, D) / D**0.5, r(D, Dh) / D**0.5,
                r(Dh) * 0.1, r(Dh) / Dh**0.5, r(1))
        cot = r(B, A, T)
        for prec in ("default", "highest"):
            lib = _build.library("grounding_head.cu", prec)
            gh.grounding_head_bwd(*args, cot, precision=prec)  # warm
            torch.cuda.synchronize()
            assert lib.vog_ph_zero() == 0
            gh.grounding_head_bwd(*args, cot, precision=prec)
            torch.cuda.synchronize()
            buf = np.zeros((2048, 2, 6), np.uint64)
            assert lib.vog_ph_read(ctypes.c_void_p(buf.ctypes.data)) == 0
            per = buf[:sms, :, :5].astype(np.float64)
            print(f"(B={B}, T={T}) {prec}: clock cycles a block (mean over {sms}, warpgroup 0 / 1): "
                  + ", ".join(f"{n} {per[:, 0, i].mean():.0f} / {per[:, 1, i].mean():.0f}" for i, n in enumerate(NAMES))
                  + f" ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
