"""Typed misuse exceptions raised by host-side validation (same classes and
messages as heongpu_tpu/utils/errors.py)."""


class HEError(ValueError):
    """Base class for all misuse errors."""


class LevelMismatchError(HEError):
    """Operands live at different modulus levels (mod_drop/rescale first)."""


class ScaleMismatchError(HEError):
    """CKKS scales differ beyond tolerance (rescale or re-encode first)."""


class CipherSizeError(HEError):
    """Ciphertext has the wrong number of polynomials for this operation."""


class ParameterError(HEError):
    """Invalid or inconsistent encryption parameters."""


def check_level(a_level: int, b_level: int, what: str = "operands") -> None:
    if a_level != b_level:
        raise LevelMismatchError(
            f"{what} at different levels ({a_level} vs {b_level}); "
            f"mod_drop/rescale to align first")


def check_scale(a_scale: float, b_scale: float, rtol: float = 1e-6) -> None:
    if abs(a_scale - b_scale) > rtol * abs(a_scale):
        raise ScaleMismatchError(
            f"scale mismatch ({a_scale:g} vs {b_scale:g}); rescale or "
            f"re-encode at the matching scale")


def check_size(got: int, want: int, op: str) -> None:
    if got != want:
        raise CipherSizeError(
            f"{op} expects a size-{want} ciphertext, got size {got}")
