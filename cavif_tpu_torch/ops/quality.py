"""Quality scale mapping: user-facing quality 1..100 -> AV1 base quantizer 0..255.

Reference semantics: /root/reference/ravif/src/av1encoder.rs:526-530
(quality_to_quantizer) and /root/reference/src/main.rs:116 (alpha quality
derivation). Verified fixed points (SURVEY.md C17): Q100->0, Q95->33, Q90->66,
Q80->121, Q60->147, Q55->153, Q40->172, Q25->191, Q1->252.
"""

from __future__ import annotations


def quality_to_quantizer(quality: float) -> int:
    """Map quality in [1, 100] to an AV1 quantizer index in [0, 255].

    Piecewise curve: x = (1-q)*2.6 for q >= 0.82; 0.875 - 0.5*q for q > 0.25;
    1 - q otherwise; quantizer = round(255*x) with ties away from zero.
    """
    if not (1.0 <= quality <= 100.0):
        raise ValueError("quality must be in 1-100 range")
    q = quality / 100.0
    if q >= 0.82:
        x = (1.0 - q) * 2.6
    elif q > 0.25:
        x = 1.0 - 0.125 - 0.5 * q
    else:
        x = 1.0 - q
    # f32::round rounds half away from zero; x*255 is nonnegative here.
    import math

    return int(math.floor(x * 255.0 + 0.5))


def alpha_quality_for(quality: float) -> float:
    """Default alpha-channel quality derived from color quality.

    alpha_q = min((q+100)/2, q + q/4 + 2); e.g. Q80->90, Q60->77, Q40->52.
    """
    return min((quality + 100.0) / 2.0, quality + quality / 4.0 + 2.0)
