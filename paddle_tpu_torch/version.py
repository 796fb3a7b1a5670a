"""The package version: counterpart of ``paddle_tpu/version.py``."""
__version__ = "0.5.0"
full_version = __version__
major, minor, patch = 0, 5, 0


def show():
    print(f"paddle_tpu_torch {__version__}")  # graftlint: disable=no-adhoc-telemetry
