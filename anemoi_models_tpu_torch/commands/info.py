"""Environment/device info command."""

from __future__ import annotations

from anemoi_models_tpu_torch.commands import register_command


@register_command("info")
class Info:
    """Print versions, the visible CUDA devices and the kernel toolchain."""

    def add_arguments(self, parser) -> None:
        pass

    def run(self, args) -> int:
        import shutil
        import sys

        import torch

        print(f"anemoi_models_tpu_torch on python {sys.version.split()[0]}, torch {torch.__version__}, "
              f"CUDA {torch.version.cuda}")
        if torch.cuda.is_available():
            for i in range(torch.cuda.device_count()):
                print(f"  cuda:{i} {torch.cuda.get_device_name(i)}")
        else:
            print("no CUDA device: run with --device cpu (the kernels' plain versions)")
        print(f"nvcc: {shutil.which('nvcc') or 'not on PATH (CUDA_HOME or /usr/local/cuda is tried)'}")
        return 0
