"""``python -m imagekit_tpu_torch.serving --port N [--device cuda|cpu]``.

Starts the HTTP app on the port's engine. The device defaults to ``cuda``
and the server refuses to start without a card unless ``--device cpu`` is
named (the plain PyTorch heads, for development).
"""

import os
import sys

# glibc arena retention balloons RSS under load; MALLOC_ARENA_MAX must be in
# the environment before glibc spawns arenas, so re-exec once with the cap
if __name__ == "__main__" and os.environ.get("MALLOC_ARENA_MAX") is None and sys.platform == "linux":
    os.environ["MALLOC_ARENA_MAX"] = "2"
    os.execv(
        sys.executable,
        [sys.executable, "-m", "imagekit_tpu_torch.serving", *sys.argv[1:]],
    )

import argparse  # noqa: E402

from imagekit_tpu_torch.serving.app import run  # noqa: E402

if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="imagekit_tpu_torch server")
    parser.add_argument("--port", type=int, default=None)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args()
    run(port=args.port, device=args.device)
