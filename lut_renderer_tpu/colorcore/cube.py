"""Adobe/Resolve .cube 3D LUT parser and writer.

The reference never parses .cube itself — it hands the path to FFmpeg's `lut3d`
filter (reference: src/lut_renderer/ffmpeg.py:246; file dialogs filter `*.cube`,
src/lut_renderer/lut_manager.py:121). Here the parser is first-party because the
LUT must live in device memory.

Semantics follow the de-facto .cube spec as implemented by FFmpeg's cube reader
(libavfilter vf_lut3d parse_cube): lines are `#` comments, `TITLE "..."`,
`LUT_3D_SIZE N`, optional `DOMAIN_MIN r g b` / `DOMAIN_MAX r g b`, then N^3 rows
of `r g b` floats with the FIRST (red) index varying fastest. The table is
stored here as a (N, N, N, 3) float32 array indexed `[r_idx, g_idx, b_idx]`,
matching FFmpeg's `lut[r*size2 + g*size + b]` layout.
"""

from __future__ import annotations

import io
from dataclasses import dataclass, field
from pathlib import Path
from typing import Union

import numpy as np

MAX_LUT_SIZE = 129  # largest size seen in the wild; guards absurd allocations
MIN_LUT_SIZE = 2


class CubeParseError(ValueError):
    pass


@dataclass
class Lut3D:
    """A 3D LUT: table[r_idx, g_idx, b_idx] -> (R, G, B) float32."""

    table: np.ndarray  # (N, N, N, 3) float32
    title: str = ""
    domain_min: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    domain_max: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))

    @property
    def size(self) -> int:
        return int(self.table.shape[0])

    @property
    def has_unit_domain(self) -> bool:
        return bool(
            np.allclose(self.domain_min, 0.0) and np.allclose(self.domain_max, 1.0)
        )

    def flat_rgb_major(self) -> np.ndarray:
        """Return (N^3, 3) with flat index = r*N^2 + g*N + b (FFmpeg layout)."""
        return np.ascontiguousarray(self.table.reshape(-1, 3))

    @staticmethod
    def identity(size: int = 33) -> "Lut3D":
        ramp = np.linspace(0.0, 1.0, size, dtype=np.float32)
        r, g, b = np.meshgrid(ramp, ramp, ramp, indexing="ij")
        table = np.stack([r, g, b], axis=-1).astype(np.float32)
        return Lut3D(table=table, title="identity")


def parse_cube(text: str, name: str = "<string>") -> Lut3D:
    size = None
    title = ""
    domain_min = np.zeros(3, np.float32)
    domain_max = np.ones(3, np.float32)
    data_lines: list[str] = []

    for raw in io.StringIO(text):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        head = line.split(None, 1)[0].upper()
        if head == "TITLE":
            rest = line.split(None, 1)[1] if len(line.split(None, 1)) > 1 else ""
            title = rest.strip().strip('"')
        elif head == "LUT_3D_SIZE":
            try:
                size = int(line.split()[1])
            except (IndexError, ValueError) as exc:
                raise CubeParseError(f"{name}: bad LUT_3D_SIZE line: {line!r}") from exc
        elif head == "LUT_1D_SIZE":
            raise CubeParseError(
                f"{name}: 1D LUTs are not supported (need LUT_3D_SIZE)"
            )
        elif head in ("DOMAIN_MIN", "DOMAIN_MAX"):
            try:
                vals = np.array([float(v) for v in line.split()[1:4]], np.float32)
            except ValueError as exc:
                raise CubeParseError(f"{name}: bad {head} line: {line!r}") from exc
            if vals.shape != (3,):
                raise CubeParseError(f"{name}: {head} needs 3 values: {line!r}")
            if head == "DOMAIN_MIN":
                domain_min = vals
            else:
                domain_max = vals
        elif head in ("LUT_3D_INPUT_RANGE", "LUT_IN_VIDEO_RANGE", "LUT_OUT_VIDEO_RANGE"):
            # Rare vendor extensions; tolerated and ignored, like most readers.
            continue
        else:
            # Data row (starts with a number, possibly negative/scientific).
            data_lines.append(line)

    if size is None:
        raise CubeParseError(f"{name}: missing LUT_3D_SIZE")
    if not (MIN_LUT_SIZE <= size <= MAX_LUT_SIZE):
        raise CubeParseError(f"{name}: unsupported LUT_3D_SIZE {size}")
    if not np.all(domain_max > domain_min):
        # A zero/negative span would divide by zero in coordinate scaling
        # (interp._prepare / ops.lut3d._scaled_coords).
        raise CubeParseError(
            f"{name}: DOMAIN_MAX must exceed DOMAIN_MIN per channel "
            f"(min={domain_min.tolist()}, max={domain_max.tolist()})"
        )

    expected = size * size * size
    # np.fromstring with an explicit sep is the fast text path (not deprecated;
    # only the binary sep='' mode is). 65^3 LUTs parse in ~100ms this way.
    flat = np.fromstring("\n".join(data_lines), dtype=np.float32, sep=" ")
    if flat.size != expected * 3:
        raise CubeParseError(
            f"{name}: expected {expected * 3} values, got {flat.size}"
        )
    # File order: red index varies fastest -> flat order is [b-slowest.. r-fastest].
    # reshape gives [b_idx, g_idx, r_idx, ch]; transpose to [r_idx, g_idx, b_idx].
    table = flat.reshape(size, size, size, 3).transpose(2, 1, 0, 3)
    table = np.ascontiguousarray(table, dtype=np.float32)
    if not np.isfinite(table).all():
        raise CubeParseError(f"{name}: non-finite values in LUT data")
    return Lut3D(table=table, title=title, domain_min=domain_min, domain_max=domain_max)


def parse_cube_file(path: Union[str, Path]) -> Lut3D:
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(str(path))
    # Fast path: the native C++ parser (~30x on 65^3 LUTs); identical error
    # taxonomy, silent fallback to the pure-Python path when unavailable.
    try:
        from ..native_ext import parse_cube_native

        parsed = parse_cube_native(path)
    except CubeParseError:
        raise
    except Exception:
        parsed = None
    if parsed is not None:
        table, dmin, dmax = parsed
        if not np.all(np.asarray(dmax) > np.asarray(dmin)):
            raise CubeParseError(
                f"{path}: DOMAIN_MAX must exceed DOMAIN_MIN per channel "
                f"(min={np.asarray(dmin).tolist()}, "
                f"max={np.asarray(dmax).tolist()})"
            )
        return Lut3D(table=table, title=_scan_title(path),
                     domain_min=dmin, domain_max=dmax)
    text = path.read_text(encoding="utf-8", errors="replace")
    return parse_cube(text, name=str(path))


def _scan_title(path: Path) -> str:
    """Cheap TITLE scan of the header so the native fast path yields the same
    Lut3D metadata as the pure-Python parser (write_cube_file round-trips)."""
    try:
        with path.open("r", encoding="utf-8", errors="replace") as fh:
            for _ in range(64):  # TITLE lives in the header, before data rows
                line = fh.readline()
                if not line:
                    break
                s = line.strip()
                if s.upper().startswith("TITLE"):
                    parts = s.split(None, 1)
                    return parts[1].strip().strip('"') if len(parts) > 1 else ""
                if s and not s.startswith("#") and s[0] in "-+.0123456789":
                    break  # reached data rows
    except OSError:
        pass
    return ""


def write_cube_file(path: Union[str, Path], lut: Lut3D) -> Path:
    """Write a .cube file (red index fastest), for fixtures and round-trip tests."""
    path = Path(path)
    n = lut.size
    out = io.StringIO()
    if lut.title:
        out.write(f'TITLE "{lut.title}"\n')
    out.write(f"LUT_3D_SIZE {n}\n")
    if not lut.has_unit_domain:
        out.write("DOMAIN_MIN %g %g %g\n" % tuple(lut.domain_min))
        out.write("DOMAIN_MAX %g %g %g\n" % tuple(lut.domain_max))
    # [r,g,b] -> file order b slowest, r fastest == transpose back.
    flat = lut.table.transpose(2, 1, 0, 3).reshape(-1, 3)
    for row in flat:
        out.write("%.6f %.6f %.6f\n" % (row[0], row[1], row[2]))
    path.write_text(out.getvalue(), encoding="utf-8")
    return path
