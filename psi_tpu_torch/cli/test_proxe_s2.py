"""Reference CLI shim for ``source/test_proxe_s2.py``."""

from psi_tpu_torch.cli.test_proxe import main as _main


def main(argv=None):
    _main(["--model_type", "s2", *(argv or [])])


if __name__ == "__main__":
    import sys

    main(sys.argv[1:])
