"""paddle.vision — models/transforms/datasets (reference: python/paddle/vision).
Model zoo (ResNet/LeNet) lands with the conv-heavy benchmark config."""
from . import transforms  # noqa: F401
from . import datasets  # noqa: F401
from . import ops  # noqa: F401
from .models import LeNet, ResNet, resnet18, resnet50  # noqa: F401


# ---- image backend (reference vision/image.py) -------------------------------
_image_backend = "pil"


def set_image_backend(backend):
    """reference vision/image.py set_image_backend: 'pil' or 'cv2'."""
    global _image_backend
    if backend not in ("pil", "cv2"):
        raise ValueError(f"backend must be 'pil' or 'cv2', got {backend!r}")
    _image_backend = backend


def get_image_backend():
    return _image_backend


def image_load(path, backend=None):
    """reference vision/image.py image_load."""
    be = backend or _image_backend
    if be == "cv2":
        try:
            import cv2
        except ImportError as e:
            raise ImportError("cv2 backend requested but OpenCV is not "
                              "installed; use the 'pil' backend") from e
        return cv2.imread(str(path))
    from PIL import Image
    return Image.open(path)
