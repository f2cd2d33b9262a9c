"""`python -m deepreadmapper_tpu_torch` == `python -m deepreadmapper_tpu_torch.cli`."""

if __name__ == "__main__":
    import sys

    from deepreadmapper_tpu_torch.cli import main

    sys.exit(main())
