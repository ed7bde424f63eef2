"""Entry point: ``python -m repro_torch.serve`` (see
:mod:`repro_torch.serve.cli`)."""

from repro_torch.serve.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
