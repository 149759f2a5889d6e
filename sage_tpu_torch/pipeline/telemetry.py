"""Minimal opt-out telemetry report.

Field parity with crates/sage-cli/src/telemetry.rs:8-33
(version, index sizes, file count, runtime, lfq/tmt/parquet flags, OS
name, total memory, CPU count) plus a ``device`` field for the CUDA
devices. POSTs fire-and-forget from a daemon thread and swallow every
error (telemetry.rs:61-77) — in an egress-less environment the send
simply fails silently.
"""

from __future__ import annotations

import json
import logging
import os
import platform
import threading
from typing import Optional

log = logging.getLogger("sage_tpu_torch")

ENDPOINT = os.environ.get("SAGE_TPU_TELEMETRY_URL", "")


def _total_memory() -> int:
    try:
        pages = os.sysconf("SC_PHYS_PAGES")
        page_size = os.sysconf("SC_PAGE_SIZE")
        return pages * page_size
    except (ValueError, OSError, AttributeError):
        return 0


def _device() -> str:
    try:
        import torch

        n = torch.cuda.device_count()
        return f"{torch.cuda.get_device_name(0)}x{n}" if n else "none"
    except Exception:  # noqa: BLE001 — never fail the run
        return "unknown"


class Telemetry:
    def __init__(
        self, search, peptides: int, fragments: int, parquet: bool,
        runtime_secs: int,
    ):
        self.payload = {
            "version": search.version,
            "peptides": peptides,
            "fragments": fragments,
            "files": len(search.mzml_paths),
            "runtime_secs": runtime_secs,
            "lfq": search.quant.lfq,
            "tmt": search.quant.tmt.kind if search.quant.tmt else None,
            "parquet": parquet,
            "os_name": f"{platform.system()} {platform.release()}",
            "total_memory": _total_memory(),
            "cpus": os.cpu_count() or 0,
            "device": _device(),
        }

    def send(self, url: Optional[str] = None) -> None:
        """Fire-and-forget POST; failures are trace-logged and ignored."""
        url = url or ENDPOINT
        if not url:
            log.debug("telemetry endpoint not configured; skipping send")
            return

        def _post():
            try:
                import urllib.request

                req = urllib.request.Request(
                    url,
                    data=json.dumps(self.payload).encode(),
                    headers={"Content-Type": "application/json"},
                )
                urllib.request.urlopen(req, timeout=5)
                log.debug("telemetry data sent successfully")
            except Exception as e:  # noqa: BLE001 — never fail the run
                log.debug("error while sending telemetry: %s", e)

        threading.Thread(target=_post, daemon=True).start()
