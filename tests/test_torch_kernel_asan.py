"""K2 and K3 under AddressSanitizer, on the CPU.

``compute-sanitizer`` does not run on the card's machine: its memcheck and
racecheck stop at "Device not supported" before the first kernel (PERF.md).
In their place, the kernels' sources are built under the shim of
``tests/test_torch_kernel_cpu.py`` (one thread a block) with
``-fsanitize=address,undefined`` and launched, in a subprocess with the ASan
runtime preloaded, on the cases the BMP, TIFF and CMYK paths give them at
small sizes: K2 with three and four channels a pixel, in whole rows and in
column strips (the RGB and RGBA heads), and K3's two launches of the
four-component pixel decode (C, M and Y with their own stacks, then K) on
the inputs ``dct.four_component_inputs`` makes from a progressive CMYK
JPEG. Every output is held against the plain version. This checks the
indexing of the global and shared memory the body touches; races it cannot
see.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

_SCRIPT = textwrap.dedent("""
    import ctypes, io, json, sys
    import numpy as np
    import torch
    from PIL import Image

    from imagekit_tpu_torch.codecs.native import jpeg_abi, loader
    from imagekit_tpu_torch.ops import _build, dct
    from imagekit_tpu_torch.ops import resize_planes as rp
    from imagekit_tpu_torch.ops import resize_strip as rs
    from imagekit_tpu_torch.ops.resize_strip import plane_record
    from tests.conftest import make_test_image
    from tests.test_torch_kernel_cpu import K2_CASES, _images, _stack, _strip_launch

    lib = ctypes.CDLL(sys.argv[1])
    _build.configure_band(lib)
    worst = {}

    def note(name, got, want):
        d = (got.int() - want.int()).abs()
        worst[name] = [int(d.max()), float((d > 0).float().mean())]

    for case in ("b5_mixed", "hole", "tall_band", "tr4"):
        B, H, W, OH, OW, U, vidx, hidx, opts = K2_CASES[case]
        wv = torch.from_numpy(_stack(H, OH, H, OH, U, **opts))
        wh = torch.from_numpy(_stack(W, OW, W, OW, U))
        v = torch.tensor(vidx, dtype=torch.int32)
        h = torch.tensor(hidx, dtype=torch.int32)
        for C in (3, 4):
            x = torch.from_numpy(_images(B, H, W * C, seed=C))
            plain = rs.rgba_resize_plain if C == 4 else rs.rgb_resize_plain
            want = plain(x, wv, wh, v.clamp(0, U - 1), h.clamp(0, U - 1))
            for strip in (0, 8):
                got = _strip_launch(lib, x, wv, wh, v, h, C, strip=strip)
                note(f"K2 {case} C={C} strip={strip}", got, want)

    buf = io.BytesIO()
    Image.fromarray(make_test_image(83, 61)).convert("CMYK").save(
        buf, "JPEG", quality=90, subsampling=2, progressive=True)
    planes, stacks, tabs, vidx = dct.four_component_inputs(
        jpeg_abi.decode4(loader.load(), buf.getvalue()), torch.device("cpu"))
    for part in (slice(0, 3), slice(3, 4)):  # the two launches
        recs, outs = [], []
        for p, (wv, wh), t in zip(planes[part], stacks[part], tabs[part]):
            B, ph, pw = p.shape
            oh, ow = wv.shape[1], wh.shape[1]
            out = torch.empty((B, oh, ow), dtype=torch.uint8)
            recs.append(plane_record(p.data_ptr(), ph * pw, pw, 1, wv, t,
                                     vidx, vidx, out, oh * ow, 0, ph, pw))
            outs.append(out)
        _build.launch_band(lib.ik_resize_planes_u8, recs, planes[0].shape[0],
                           None)
        for i, (out, p, (wv, wh)) in enumerate(zip(outs, planes[part],
                                                   stacks[part])):
            note(f"K3 CMYK plane {part.start + i}", out,
                 rp.resize_planes_plain(p, wv, wh, vidx))
    print(json.dumps(worst))
""")


def test_k2_and_k3_under_address_sanitizer(tmp_path):
    from tests.test_torch_kernel_cpu import CSRC, SHIM

    (tmp_path / "cuda_runtime.h").write_text(SHIM)
    so = tmp_path / "libik_band_asan.so"
    san = ["-fsanitize=address,undefined", "-fno-sanitize-recover=undefined"]
    objs = [tmp_path / f"{name}.o" for name in ("resize_strip",
                                                "resize_planes")]
    builds = [subprocess.Popen(
        ["g++", "-std=c++17", "-O0", "-g", "-ffp-contract=off", "-fPIC",
         *san, "-I", str(tmp_path), "-x", "c++", "-c",
         str(CSRC / f"{o.stem}.cu"), "-o", str(o)]) for o in objs]
    assert [b.wait(timeout=600) for b in builds] == [0, 0]
    subprocess.run(["g++", "-shared", *san, *map(str, objs), "-o", str(so)],
                   check=True, timeout=300)
    asan = subprocess.run(["g++", "-print-file-name=libasan.so"],
                          capture_output=True, text=True).stdout.strip()
    env = {**os.environ, "LD_PRELOAD": asan,
           "ASAN_OPTIONS": "detect_leaks=0:abort_on_error=1",
           "UBSAN_OPTIONS": "print_stacktrace=1:halt_on_error=1",
           "PYTHONPATH": os.pathsep.join(
               [str(ROOT), os.environ.get("PYTHONPATH", "")])}
    proc = subprocess.run([sys.executable, "-c", _SCRIPT, str(so)],
                          capture_output=True, text=True, env=env,
                          timeout=900, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-6000:]
    assert "Sanitizer" not in proc.stderr, proc.stderr[-6000:]
    assert "runtime error" not in proc.stderr, proc.stderr[-6000:]
    worst = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(worst) == 4 * 2 * 2 + 4
    for name, (mx, share) in worst.items():
        assert mx <= 1 and share <= 1e-3, (name, mx, share)


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q"]))
