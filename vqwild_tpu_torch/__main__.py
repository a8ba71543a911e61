"""``python -m vqwild_tpu_torch``: the port's command line
(vqwild_tpu_torch/apps/cli.py)."""

from vqwild_tpu_torch.apps.cli import main

if __name__ == "__main__":
    main()
