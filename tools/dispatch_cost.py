#!/usr/bin/env python3
"""What the kernels' fake route costs a call on the card: a ``gossip_mix_op``
call through its wrapper (whose fake route is one ``is_fake`` branch)
against the same call through a ``torch.library.custom_op`` with a
registered fake, the mechanism PyTorch offers for the same purpose.

    python3 tools/dispatch_cost.py

At (1, 4, 1024) f32, where the kernel's own time is small: 100 warm-up
calls, then the mean host time of 2,000 calls (host clock, synchronized
at both ends), in the order wrapper, custom op, custom op, wrapper.
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "src"))

import torch  # noqa: E402

from repro_torch.kernels.mixing.ops import gossip_mix_op  # noqa: E402


def host_us(fn, calls: int = 2000) -> float:
    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return 1e6 * (time.perf_counter() - t0) / calls


def main() -> int:
    if not torch.cuda.is_available():
        print("tools/dispatch_cost.py needs a CUDA card", file=sys.stderr)
        return 1

    @torch.library.custom_op("dispatch_cost::mix", mutates_args=(),
                             schema="(Tensor buf, Tensor w) -> Tensor")
    def mix_custom(buf, w):
        return gossip_mix_op(buf, w)

    @mix_custom.register_fake
    def _(buf, w):
        return buf.new_empty((buf.shape[0], buf.shape[2]))

    dev = torch.device("cuda")
    buf = torch.randn((1, 4, 1024), generator=torch.Generator(device=dev).manual_seed(7),
                      device=dev)
    w = torch.full((4,), 0.25, device=dev)
    if not torch.equal(mix_custom(buf, w), gossip_mix_op(buf, w)):
        print("the custom op's result differs from the wrapper's", file=sys.stderr)
        return 1
    costs = {"wrapper": [], "custom_op": []}
    for name in ("wrapper", "custom_op", "custom_op", "wrapper"):
        fn = (lambda: gossip_mix_op(buf, w)) if name == "wrapper" else (lambda: mix_custom(buf, w))
        costs[name].append(host_us(fn))
    print(f"[dispatch] a gossip_mix call at (1, 4, 1024), host time: the wrapper (is_fake "
          f"branch) {' / '.join(f'{t:.1f}' for t in costs['wrapper'])} us, through a custom_op "
          f"with register_fake {' / '.join(f'{t:.1f}' for t in costs['custom_op'])} us, on "
          f"{torch.cuda.get_device_name(0)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
