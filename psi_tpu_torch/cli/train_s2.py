"""Reference CLI shim for ``source/train_s2.py``."""

from psi_tpu_torch.cli.train import main as _main


def main(argv=None):
    _main(["--model_type", "s2", *(argv or [])])


if __name__ == "__main__":
    import sys

    main(sys.argv[1:])
