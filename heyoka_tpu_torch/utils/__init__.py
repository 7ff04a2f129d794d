"""Utility subsystems, copied from ``heyoka_tpu.utils``: time scales and
TLE parsing (``eop_sw_updater``, which downloads, is not ported).

Reference parity: the small host-side subset of heyoka's vendored ERFA
(``src/detail/erfa/*.c``) that the framework actually needs — time-scale
conversions and Earth-rotation angles — reimplemented from the published
IAU algorithms (SURVEY.md §2 #32), plus the GPE/TLE tooling.
"""

from .timeconv import (  # noqa: F401
    jd_utc_to_tai,
    jd_tai_to_utc,
    jd_tai_to_tt,
    jd_tt_to_tai,
    jd_utc_to_tt,
    tai_minus_utc,
    jd_to_cal,
    cal_to_jd,
)
from .tle import parse_tle, parse_tle_file  # noqa: F401
