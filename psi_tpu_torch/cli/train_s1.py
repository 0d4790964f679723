"""Reference CLI shim: ``python -m psi_tpu_torch.cli.train_s1 --save_dir ...``
(the reference's ``source/train_s1.py`` surface) -> the unified trainer."""

from psi_tpu_torch.cli.train import main as _main


def main(argv=None):
    _main(["--model_type", "s1", *(argv or [])])


if __name__ == "__main__":
    import sys

    main(sys.argv[1:])
