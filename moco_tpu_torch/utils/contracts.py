"""Process exit codes (the part of moco_tpu/utils/contracts.py the port
uses): one source for the code a supervisor keys its restart on."""

from __future__ import annotations

STALL_EXIT_CODE = 42  # utils/watchdog.py: the watchdog fired, no step for `timeout`

EXIT_CODES = {
    "stall": STALL_EXIT_CODE,
}
