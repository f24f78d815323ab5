import sys

from anemoi_models_tpu_torch.commands import main

if __name__ == "__main__":
    sys.exit(main())
