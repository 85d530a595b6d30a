"""`python -m musicnlp_tpu_torch <command>`: see `musicnlp_tpu_torch/cli.py`."""
from musicnlp_tpu_torch.cli import main

if __name__ == '__main__':
    raise SystemExit(main())
