"""Host-side image IO: decode files into batched numpy frame tensors.

The reference delegates decode to OpenCV ``imgcodecs::imread``
(``src/utils.rs:111-117``, ``read_grey_and_f32`` at ``src/utils.rs:128-144``).
Decode is not an accelerator job (SURVEY.md N16): we decode on host (PIL) with a
thread pool standing in for the Rayon fan-out, then ship one batched
``[N,H,W,C] uint8`` tensor to device.  When the optional native C++
loader is built (``native/``), it transparently replaces the PIL path.

Channel order: we standardise on **RGB** in memory (PIL native order).
The reference holds BGR Mats, but its grayscale conversion weights
(``COLOR_BGR2GRAY``) equal the standard Rec.601 luma applied to RGB, so
per-pixel behavior is identical; only the channel order of the returned
color stack differs and is documented in the public API.
"""

from __future__ import annotations

import concurrent.futures
import functools
import os
from pathlib import Path
from typing import List, Sequence, Union

import numpy as np

from ..errors import NotEnoughFilesError, StackerIoError

PathLike = Union[str, os.PathLike]

_IMAGE_EXTENSIONS = {".jpg", ".jpeg", ".tif", ".png"}


def collect_image_files(directory: PathLike) -> List[Path]:
    """Return paths of all jpg/jpeg/tif/png files in a directory
    (non-recursive), mirroring ``collect_image_files`` at
    reference ``examples/main.rs:10-22``."""
    directory = Path(directory)
    try:
        entries = sorted(directory.iterdir())
    except OSError as e:
        raise StackerIoError(str(e)) from e
    return [
        p
        for p in entries
        if p.is_file() and p.suffix.lower() in _IMAGE_EXTENSIONS
    ]


def normalize_files(files) -> list:
    """Normalise a ``files`` argument: a bare str/PathLike is a
    directory of frames (or a single image file), NOT an iterable of
    one-character file names; anything else is materialised as a
    list."""
    if isinstance(files, (str, os.PathLike)):
        if os.path.isdir(files):
            return list(collect_image_files(files))
        return [files]
    return list(files)


def imread_unchanged(path: PathLike) -> np.ndarray:
    """Decode one image preserving its native depth — the counterpart of
    ``imread(..., IMREAD_UNCHANGED)`` at ref src/utils.rs:111-117.
    16-bit PNG/TIFF decodes to uint16 ``[H,W]`` or ``[H,W,3]``; 8-bit
    files decode like :func:`imread_rgb`."""
    from PIL import Image

    try:
        with Image.open(path) as im:
            if im.mode in ("I;16", "I;16B", "I;16L", "I"):
                return np.asarray(im, dtype=np.uint16)
            if im.mode in ("RGB;16", "I;16N"):
                return np.asarray(im, dtype=np.uint16)
            return np.asarray(im.convert("RGB"), dtype=np.uint8)
    except OSError as e:
        raise StackerIoError(f"{path}: {e}") from e


def imread_rgb(path: PathLike) -> np.ndarray:
    """Decode one image file to an RGB uint8 array ``[H,W,3]``.

    Counterpart of ``utils::imread`` (ref src/utils.rs:111-117) with
    IMREAD_UNCHANGED followed by the implicit 3-channel assumption of
    ``read_grey_and_f32``; grayscale files are expanded to 3 channels.
    16-bit inputs (PIL ``I;16`` TIFF/PNG) are scaled to 8 bits by
    dropping the low byte — a documented deviation: the reference passes
    16-bit Mats through, but every OpenCV stage it then calls (ORB, ECC)
    asserts 8-bit/float input, so 16-bit bursts fail downstream there.
    Use :func:`imread_unchanged` for raw-depth access.
    """
    from PIL import Image

    try:
        with Image.open(path) as im:
            if im.mode in ("I;16", "I;16B", "I;16L", "I;16N", "I"):
                arr = np.asarray(im, dtype=np.uint32)
                arr8 = (arr >> 8).clip(0, 255).astype(np.uint8)
                if arr8.ndim == 2:
                    arr8 = np.repeat(arr8[:, :, None], 3, axis=2)
                return arr8
            im = im.convert("RGB")
            return np.asarray(im, dtype=np.uint8)
    except OSError as e:
        raise StackerIoError(f"{path}: {e}") from e


imread = imread_rgb  # reference-style name (utils::imread, src/utils.rs:111)


def imread_gray(path: PathLike) -> np.ndarray:
    """Decode one image file directly to uint8 grayscale ``[H,W]`` using
    the same Rec.601 fixed-point conversion as the device path
    (counterpart of imread(..., IMREAD_GRAYSCALE) at examples/main.rs:40)."""
    rgb = imread_rgb(path)
    return rgb_to_gray_u8_host(rgb)


def rgb_to_gray_u8_host(rgb: np.ndarray) -> np.ndarray:
    """Host (numpy) Rec.601 luma with OpenCV's exact fixed-point rounding:
    grey = (9798*R + 19235*G + 3735*B + 2^14) >> 15  (cvtColor BGR2GRAY
    weights, ref src/utils.rs:136-142 / SURVEY.md N17)."""
    r = rgb[..., 0].astype(np.int32)
    g = rgb[..., 1].astype(np.int32)
    b = rgb[..., 2].astype(np.int32)
    return ((9798 * r + 19235 * g + 3735 * b + (1 << 14)) >> 15).astype(np.uint8)


def save_image(path: PathLike, img: np.ndarray, bit_depth: int = 8) -> None:
    """Write a stacked image to disk.

    ``img`` is ``[H,W,3]`` float in [0, 1] (the pipelines' output) or an
    already-quantised uint8/uint16 array.  ``bit_depth=8`` writes through
    PIL in whatever format the extension names; ``bit_depth=16`` writes a
    48-bit RGB PNG — a stacked burst carries more than 8 bits of real
    depth (a 100-frame mean adds ~log2(100) bits), which the reference's
    example flow cannot preserve (its imwrite of an 8-bit Mat,
    examples/main.rs:150-158).  Encoding prefers the native libpng
    writer (native/stacker_io.cpp) and falls back to a pure-Python
    encoder (PIL has no 48-bit RGB mode).
    """
    if bit_depth == 8:
        from PIL import Image

        if img.dtype == np.uint8:
            arr = np.asarray(img)
        else:
            arr = np.clip(
                np.asarray(img, np.float32) * 255.0 + 0.5, 0, 255
            ).astype(np.uint8)
        Image.fromarray(arr).save(str(path))
        return
    if bit_depth != 16:
        raise ValueError(f"bit_depth must be 8 or 16, got {bit_depth}")
    if str(path).lower().endswith((".tif", ".tiff")):
        raise StackerIoError("16-bit output is PNG only (use a .png path)")
    if img.dtype == np.uint16:
        arr16 = np.asarray(img)
    elif img.dtype == np.uint8:
        # 257 = 0x0101: replicates the byte (0xAB -> 0xABAB), the exact
        # 8->16 range expansion (255 -> 65535)
        arr16 = np.asarray(img, np.uint16) * np.uint16(257)
    else:
        arr16 = np.clip(
            np.asarray(img, np.float32) * 65535.0 + 0.5, 0, 65535
        ).astype(np.uint16)
    if arr16.ndim == 2:
        arr16 = np.repeat(arr16[:, :, None], 3, axis=2)
    from . import native_loader

    try:
        native_loader.write_png16_native(path, arr16)
        return
    except StackerIoError:
        pass  # library not built — pure-Python encoder below
    _write_png16_py(path, arr16)


def _write_png16_py(path: PathLike, rgb16: np.ndarray) -> None:
    """Minimal 48-bit RGB PNG encoder (filter 0 scanlines, one zlib
    IDAT).  Fallback for :func:`save_image` when the native library is
    not built; byte semantics identical to the libpng path."""
    import struct
    import zlib

    h, w = rgb16.shape[:2]

    def chunk(tag: bytes, payload: bytes) -> bytes:
        body = tag + payload
        return (
            struct.pack(">I", len(payload))
            + body
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 16, 2, 0, 0, 0)
    # big-endian samples, filter byte 0 per scanline
    be = np.ascontiguousarray(rgb16, dtype=">u2").reshape(h, w * 3)
    raw = b"".join(b"\x00" + be[y].tobytes() for y in range(h))
    data = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    try:
        with open(path, "wb") as f:
            f.write(data)
    except OSError as e:
        raise StackerIoError(f"{path}: {e}") from e


def pad_chunk(
    frames: np.ndarray, chunk_size: int, fill: np.ndarray | None = None
) -> np.ndarray:
    """Pad a final partial chunk to ``chunk_size`` lanes — every chunk
    then has one static shape, so the jitted grey/solve/warp programs
    compile exactly once per burst geometry instead of recompiling for
    the odd tail.

    ``fill`` (default: repeat the last frame) chooses the pad content;
    the ECC stream passes the REFERENCE frame so pad lanes solve the
    identity alignment and converge in ~2 iterations instead of
    re-solving the last real frame's warp."""
    n = frames.shape[0]
    if n == chunk_size:
        return frames
    src = frames[-1:] if fill is None else np.asarray(fill)[None]
    reps = np.repeat(src, chunk_size - n, axis=0)
    return np.concatenate([frames, reps], axis=0)


def _png_bit_depth(path: PathLike) -> int | None:
    """IHDR bit depth of a PNG file (header sniff), or None if the file
    is not a PNG.  Used to refuse a silent 16->8 reduction when the
    native decoder is unavailable."""
    try:
        with open(path, "rb") as f:
            head = f.read(25)
    except OSError as e:
        raise StackerIoError(f"{path}: {e}") from e
    if head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        return None
    return head[24]


def _tiff_is_16bit(path: PathLike) -> bool:
    """True if a TIFF file's BitsPerSample is 16 (PIL tag read; False
    for non-TIFF files)."""
    if not str(path).lower().endswith((".tif", ".tiff")):
        return False
    from PIL import Image

    try:
        with Image.open(path) as im:
            bits = im.tag_v2.get(258)  # BitsPerSample
    except (OSError, AttributeError):
        return False
    if bits is None:
        return False
    vals = bits if isinstance(bits, (tuple, list)) else (bits,)
    return any(int(b) == 16 for b in vals)


def _load_frames_u16(files, num_threads, use_native: bool) -> np.ndarray:
    """Full-depth decode -> [N,H,W,3] uint16 (see load_frames)."""
    from . import native_loader

    if use_native and native_loader.available16() and all(
        str(f).lower().endswith((".jpg", ".jpeg", ".png", ".tif", ".tiff"))
        for f in files
    ):
        try:
            return native_loader.load_frames_native16(
                files, num_threads or 0
            )
        except StackerIoError:
            pass  # unusual subformats: per-file PIL fallback below

    def one(path):
        arr = imread_unchanged(path)
        if arr.dtype == np.uint8:
            # PIL reduces 48-bit RGB PNG/TIFF content to 8 silently —
            # refuse the depth loss instead of shipping it
            if _png_bit_depth(path) == 16 or _tiff_is_16bit(path):
                raise StackerIoError(
                    f"{path} holds 16-bit samples; full-depth decode "
                    "needs the native loader (make -C native)"
                )
            arr = arr.astype(np.uint16) * np.uint16(257)
        elif arr.dtype != np.uint16:
            raise StackerIoError(
                f"{path}: unsupported depth {arr.dtype} for "
                "preserve_depth load"
            )
        if arr.ndim == 2:
            arr = np.repeat(arr[:, :, None], 3, axis=2)
        return arr

    frames = [one(f) for f in files]
    shape0 = frames[0].shape
    for f, arr in zip(files, frames):
        if arr.shape != shape0:
            raise StackerIoError(
                f"frame size mismatch: {f} has {arr.shape}, "
                f"expected {shape0}"
            )
    return np.stack(frames, axis=0)


def prefetched_chunks(files, chunk_size: int, h: int, w: int,
                      start: int = 1, preserve_depth: bool = False):
    """Yield decoded ``[<=chunk_size, H, W, 3]`` frame tensors, decoding
    the NEXT chunk on a background thread while the caller's device work
    runs — host->HBM double buffering for the streaming pipelines
    (SURVEY.md §7 phase 6)."""
    import concurrent.futures

    spans = [
        files[s0 : s0 + chunk_size]
        for s0 in range(start, len(files), chunk_size)
    ]
    if not spans:
        return
    load = functools.partial(load_frames, preserve_depth=preserve_depth)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fut = pool.submit(load, spans[0])
        for i, span in enumerate(spans):
            frames = fut.result()
            if i + 1 < len(spans):
                fut = pool.submit(load, spans[i + 1])
            if frames.shape[1:3] != (h, w):
                raise StackerIoError(
                    f"frame size mismatch in chunk starting at {span[0]}"
                )
            yield frames


def load_frames(
    files: Sequence[PathLike], *, num_threads: int | None = None,
    use_native: bool = True, preserve_depth: bool = False,
) -> np.ndarray:
    """Decode ``files`` into one batched ``[N,H,W,3] uint8`` tensor.

    All frames must share the first frame's spatial size (the reference
    implicitly requires this: every frame is warped onto frame 0's grid,
    ref src/lib.rs:291-299).  Decoding prefers the native C++ thread-pool
    loader (native/stacker_io.cpp — the counterpart of the reference's
    OpenCV imgcodecs + Rayon fan-out) and falls back to a PIL thread
    pool when the shared library isn't built.

    ``preserve_depth=True`` returns ``uint16`` instead: 16-bit PNG/TIFF
    decode at full depth and 8-bit sources expand x257, so the
    pipelines stack at 16-bit precision (they align on the high byte
    either way — see ops.color.depth_reduce_u8).  16-bit RGB needs the
    native loader (PIL silently reduces 48-bit content to 8).
    """
    files = normalize_files(files)
    if not files:
        raise NotEnoughFilesError()
    if preserve_depth:
        return _load_frames_u16(files, num_threads, use_native)
    if use_native:
        from . import native_loader

        if native_loader.available() and all(
            str(f).lower().endswith((".jpg", ".jpeg", ".png", ".tif",
                                     ".tiff"))
            for f in files
        ):
            try:
                return native_loader.load_frames_native(
                    files, num_threads or 0
                )
            except StackerIoError:
                pass  # fall back to PIL (e.g. unusual subformats)
    if num_threads is None:
        num_threads = min(len(files), os.cpu_count() or 1)
    if num_threads <= 1 or len(files) == 1:
        frames = [imread_rgb(f) for f in files]
    else:
        with concurrent.futures.ThreadPoolExecutor(num_threads) as pool:
            frames = list(pool.map(imread_rgb, files))
    shape0 = frames[0].shape
    for f, arr in zip(files, frames):
        if arr.shape != shape0:
            raise StackerIoError(
                f"frame size mismatch: {f} has {arr.shape}, expected {shape0}"
            )
    return np.stack(frames, axis=0)
