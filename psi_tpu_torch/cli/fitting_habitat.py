"""Reference CLI shim for ``fitting_habitat.py gen_path fit_path``."""

from psi_tpu_torch.cli.fitting import main as _main


def main(argv=None):
    import sys

    argv = list(argv if argv is not None else sys.argv[1:])
    _main([*argv[:2], "--dataset", "habitat", *argv[2:]])


if __name__ == "__main__":
    main()
