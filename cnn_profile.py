"""Where a training step of the port's ResNet-18 (width 64, 64x64x3 images)
spends its time on one NVIDIA GPU.

    python3 cnn_profile.py [BATCH]        # default 256

Prints the card's name and power limit, the time of one AdamW step
(``models.train.train_step``, CUDA events over 10 steps after 3 warm-up
steps, beside the host's clock), the kernels of 3 profiled steps by device
time (``torch.profiler``), and the same step in three variants that the
package does not use, to show what the layout and the norm's type cost:
plain NCHW memory instead of channels_last, and GroupNorm computed in
bfloat16 instead of autocast's float32, each alone and together. Last, one
forward pass without gradients. Nothing here is a kernel of the port: the
convolutions are cuDNN's and the rest PyTorch's own operators.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    import torch
    import torch.nn.functional as F
    from torch import nn
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("cnn_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from tpumcia_torch.models.cnn import ResNet, init_parameters, make_resnet
    from tpumcia_torch.models.train import CNNConfig, make_optimizer, train_step

    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "?", flush=True)
    torch.backends.cudnn.benchmark = True
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((batch, 64, 64, 3), device=dev, generator=gen)
    y = torch.randint(0, 6, (batch,), device=dev, generator=gen)
    cfg = CNNConfig(num_classes=6)

    class PlainLayout(ResNet):
        """The same network on NCHW-contiguous memory."""

        def forward(self, x):
            x = x.to(torch.float32).permute(0, 3, 1, 2).contiguous()
            with self._compute(x.device.type):
                x = F.relu(self.GroupNorm_0(self.stem(x)))
                for name in self.block_names:
                    x = getattr(self, name)(x)
                x = x.mean(dim=(2, 3))
            with torch.autocast(x.device.type, enabled=False):
                return self.classifier(x.to(torch.float32))

    def build(channels_last: bool):
        model = make_resnet(6, in_channels=3)
        init_parameters(model, torch.Generator().manual_seed(0))
        if channels_last:
            return model.to(dev, memory_format=torch.channels_last)
        model.__class__ = PlainLayout
        return model.to(dev)

    def step_ms(model, steps=10):
        opt = make_optimizer(model, cfg)
        for _ in range(3):
            train_step(model, opt, x, y)
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        for _ in range(steps):
            train_step(model, opt, x, y)
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / steps, (time.perf_counter() - t0) / steps * 1e3, opt

    model = build(True)
    ms, wall, opt = step_ms(model)
    print(f"the package's step (channels_last, GroupNorm float32 under autocast), batch {batch}: "
          f"{ms!r} ms device, {wall!r} ms host clock", flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            train_step(model, opt, x, y)
        torch.cuda.synchronize()
    rows = [r for r in prof.key_averages() if r.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda r: -r.self_device_time_total)
    total = sum(r.self_device_time_total for r in rows)
    print(f"device time {total / 3e3!r} ms a step over 3 profiled steps; kernels by device time:")
    for r in rows[:18]:
        print(f"  {r.self_device_time_total / 3e3:8.3f} ms a step  x{r.count // 3:4d}  {r.key[:100]}")

    print(f"variant, plain NCHW memory: {step_ms(build(False))[0]!r} ms device", flush=True)
    norm_forward = nn.GroupNorm.forward

    def norm_bf16(self, x):
        with torch.autocast("cuda", enabled=False):
            return F.group_norm(x.to(torch.bfloat16), self.num_groups, self.weight.to(torch.bfloat16),
                                self.bias.to(torch.bfloat16), self.eps)

    nn.GroupNorm.forward = norm_bf16
    try:
        print(f"variant, channels_last with GroupNorm in bfloat16: {step_ms(build(True))[0]!r} ms device", flush=True)
        print(f"variant, plain NCHW memory with GroupNorm in bfloat16: {step_ms(build(False))[0]!r} ms device",
              flush=True)
    finally:
        nn.GroupNorm.forward = norm_forward
    with torch.no_grad():
        for _ in range(3):
            model(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            model(x)
        torch.cuda.synchronize()
    print(f"forward only, the package's model: {(time.perf_counter() - t0) * 100!r} ms per {batch} images")
    return 0


if __name__ == "__main__":
    sys.exit(main())
