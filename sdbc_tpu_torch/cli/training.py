"""Alias entry point (counterpart of ``sdbc_tpu/cli/training.py``): the
reference README names the trainer ``training.py``.  Same CLI as
``cli/finetune.py``."""
from sdbc_tpu_torch.cli.finetune import build_parser, main  # noqa: F401

if __name__ == "__main__":
    main()
