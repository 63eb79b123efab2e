"""Error hierarchy mirroring ravif's error enum.

Reference: /root/reference/ravif/src/error.rs:7-25 (Error{TooFewPixels,
Unsupported, EncodingError}).
"""


class CavifError(Exception):
    """Base class for all cavif-tpu errors."""


class TooFewPixelsError(CavifError):
    """Input buffer holds fewer pixels than width*height."""

    def __str__(self) -> str:  # matches reference display string intent
        return "too few pixels in the input buffer"


class UnsupportedError(CavifError):
    """A feature combination that the encoder does not support."""

    def __init__(self, what: str):
        super().__init__(what)
        self.what = what

    def __str__(self) -> str:
        return f"unsupported: {self.what}"


class EncodingError(CavifError):
    """The AV1 encode itself failed."""
