"""Reference CLI shim for ``source/test_proxe_s1.py``."""

from psi_tpu_torch.cli.test_proxe import main as _main


def main(argv=None):
    _main(["--model_type", "s1", *(argv or [])])


if __name__ == "__main__":
    import sys

    main(sys.argv[1:])
