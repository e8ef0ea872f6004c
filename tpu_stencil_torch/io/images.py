"""Standard image-format I/O (PNG/JPEG/PPM/BMP/TIFF/...) via Pillow.

The reference only speaks headerless ``.raw`` (its README walks users
through ImageMagick ``convert`` side-steps to get one). Here any format
Pillow can decode is a first-class input: the CLI accepts ``photo.png`` in
place of ``photo.raw`` and infers width/height from the header (pass ``0 0``
for the positional width/height, or the true values to cross-check).

Raw semantics are preserved exactly: decoding normalizes to the same uint8
(H, W) grey / (H, W, 3) interleaved RGB arrays the raw reader produces
(``tpu_stencil_torch.io.raw``), so every backend and the golden model see
identical data regardless of container format. ``--frames`` clips stay
raw-only.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from tpu_stencil_torch.config import ImageType

_RAW_EXTS = {".raw", ".bin", ""}

# Magic bytes of the formats Pillow commonly decodes; a known signature on
# an extension-less input file means "this is NOT headerless raw". Only
# signatures >= 3 bytes match on prefix alone; the 2-byte BMP/PNM magics
# need corroborating header structure (below) or arbitrary pixel data would
# collide with them (~1 in 8k files).
_MAGIC_PREFIX = (
    b"\x89PNG\r\n\x1a\n",  # PNG
    b"\xff\xd8\xff",       # JPEG
    b"GIF8",               # GIF
    b"II*\x00",            # TIFF little-endian
    b"MM\x00*",            # TIFF big-endian
)


def _sniffs_as_image(path: str) -> bool:
    try:
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            head = f.read(12)
    except OSError:
        return False  # unreadable/nonexistent: not a decodable image
    if head.startswith(_MAGIC_PREFIX):
        return True
    # BMP: 'BM' + a little-endian file-size field that must match reality.
    if head[:2] == b"BM" and len(head) >= 6:
        if int.from_bytes(head[2:6], "little") == size:
            return True
    # PNM: 'P1'..'P6' followed by whitespace (the spec requires it).
    if (len(head) >= 3 and head[0:1] == b"P" and head[1:2] in b"123456"
            and head[2:3] in b" \t\r\n"):
        return True
    return False


def is_raw(path: str, sniff: bool = False) -> bool:
    """Headerless-raw heuristic: .raw/.bin extensions are raw, known image
    extensions are not, extension-less paths are raw by default.

    ``sniff=True`` (for *input* paths only) additionally checks magic bytes
    of existing extension-less files, so a PNG saved without an extension is
    decoded instead of being fed to the raw reader (which would fail with a
    confusing size mismatch or, worse, silently decode garbage). Output
    paths must never sniff: classification of an output would otherwise
    depend on what a previous run left at that path."""
    ext = os.path.splitext(path)[1].lower()
    if ext != "":
        return ext in _RAW_EXTS
    if not sniff:
        return True
    return not _sniffs_as_image(path)


def _pil():
    try:
        from PIL import Image
    except ImportError as e:  # Pillow is an optional dependency
        raise ValueError(
            "reading/writing non-raw image formats requires Pillow "
            "(the images extra); or use headerless .raw"
        ) from e
    return Image


def probe_size(path: str) -> Tuple[int, int]:
    """(width, height) from the image header (no full decode)."""
    Image = _pil()

    with Image.open(path) as im:
        return im.size  # PIL size is (W, H)


def load_image(path: str, image_type: ImageType) -> np.ndarray:
    """Decode any Pillow-supported file to the framework's array form:
    uint8 (H, W) for grey, (H, W, 3) interleaved for rgb."""
    Image = _pil()

    with Image.open(path) as im:
        im = im.convert("L" if image_type is ImageType.GREY else "RGB")
        arr = np.asarray(im, dtype=np.uint8)
    return arr


def save_image(path: str, arr: np.ndarray) -> None:
    """Encode a uint8 (H, W[, 3]) array to ``path`` (format from extension)."""
    Image = _pil()

    arr = np.asarray(arr, dtype=np.uint8)
    if arr.ndim == 3 and arr.shape[2] == 1:
        arr = arr[..., 0]
    mode = "L" if arr.ndim == 2 else "RGB"
    Image.fromarray(arr, mode=mode).save(path)


def resolve_size(
    path: str, width: int, height: int
) -> Tuple[int, int]:
    """Final (width, height) for an input file.

    Raw files: both must be positive (the file is headerless). Image
    formats: 0 means "from header"; nonzero values are cross-checked
    against the header and a mismatch is an error (the reference silently
    reads garbage on wrong sizes — we fail loudly, as the raw reader
    already does for short files)."""
    if is_raw(path, sniff=True):
        if width <= 0 or height <= 0:
            raise ValueError(
                f"{path}: raw images are headerless; width/height must be "
                "given explicitly"
            )
        return width, height
    w, h = probe_size(path)
    if width not in (0, w) or height not in (0, h):
        raise ValueError(
            f"{path}: header says {w}x{h} but CLI args say {width}x{height}"
        )
    return w, h
