"""Path/URL abstraction + file-format dispatch.

Parity with crates/sage-cloudpath/src/{lib,util}.rs:
local paths and URLs normalize into a (scheme, path) pair (lib.rs:20-43);
reads stream through transparent gzip when the name ends in gz/gzip
(lib.rs:45-48); spectra dispatch on extension into mzML/MGF/Bruker-TDF
parsers (util.rs:31-72; Bruker `.d` input reads local directories
only, through ``io/tdf.py``); Bruker `.d` names resolve to the parent
directory (lib.rs:52-63).

Cloud backends: the reference uses the `object_store` crate for
s3/gs/az/http. This environment has no cloud SDKs and no egress, so
those schemes are *gated*: the URL plumbing recognizes and routes them,
`http(s)` uses urllib, and s3/gs/az raise a clear error naming the
missing dependency (`boto3` / `google-cloud-storage` /
`azure-storage-blob`) — install one and `_read_cloud_bytes` picks it up.
"""

from __future__ import annotations

import gzip
import io
import logging
import os
import urllib.parse
import urllib.request
from typing import List, Optional, Tuple

log = logging.getLogger("sage_tpu_torch")

# lib.rs:21-24 — single-letter schemes (Windows drive letters) are paths
OBJECT_STORE_SCHEMES = (
    "file", "memory", "s3", "s3a", "gs", "az", "adl", "azure", "abfs",
    "abfss", "http", "https",
)

# NOTE: "ms2" and "raw" intentionally lack the dot — parity with the
# reference's BRUKER_EXTENSIONS (util.rs:45-57), which matches any path
# ENDING in those letters.
BRUKER_EXTENSIONS = (".d", ".tdf", ".tdf_bin", "ms2", "raw")


def try_parse_url(s: str) -> Optional[Tuple[str, str]]:
    """(scheme, rest) if `s` is a URL with a recognized scheme (lib.rs:28-34)."""
    parsed = urllib.parse.urlparse(s)
    if parsed.scheme in OBJECT_STORE_SCHEMES:
        return parsed.scheme, s
    return None


def to_url(s: str) -> Tuple[str, str]:
    """Normalize a path-or-URL into (scheme, location) (lib.rs:36-43).
    Local paths are canonicalized and must exist."""
    url = try_parse_url(s)
    if url is not None:
        return url
    path = os.path.realpath(s)
    if not os.path.exists(path):
        raise FileNotFoundError(s)
    return "file", path


def is_gzip(name: str) -> bool:
    """lib.rs:45-48."""
    return name.endswith("gz") or name.endswith("gzip")


def filename(s: str) -> Optional[str]:
    """Filename portion; `.tdf` resolves to the parent dir name — the
    Bruker `.d` convention (lib.rs:52-63)."""
    path = urllib.parse.urlparse(s).path if try_parse_url(s) else s
    parts = [p for p in path.replace("\\", "/").rstrip("/").split("/") if p]
    if not parts:
        return None
    if parts[-1].endswith("tdf") and len(parts) >= 2:
        return parts[-2]
    return parts[-1] if parts[-1] else None


def _read_cloud_bytes(scheme: str, url: str) -> bytes:
    if scheme in ("http", "https"):
        with urllib.request.urlopen(url) as resp:
            return resp.read()
    if scheme in ("s3", "s3a"):
        try:
            import boto3  # noqa: F401
        except ImportError as e:
            raise RuntimeError(
                f"reading {url} requires the boto3 package (not installed "
                "in this environment)"
            ) from e
        parsed = urllib.parse.urlparse(url)
        s3 = boto3.client("s3")
        obj = s3.get_object(Bucket=parsed.netloc, Key=parsed.path.lstrip("/"))
        return obj["Body"].read()
    if scheme == "gs":
        try:
            from google.cloud import storage  # noqa: F401
        except ImportError as e:
            raise RuntimeError(
                f"reading {url} requires google-cloud-storage (not installed "
                "in this environment)"
            ) from e
        parsed = urllib.parse.urlparse(url)
        client = storage.Client()
        blob = client.bucket(parsed.netloc).blob(parsed.path.lstrip("/"))
        return blob.download_as_bytes()
    if scheme in ("az", "azure", "adl", "abfs", "abfss"):
        try:
            from azure.storage.blob import BlobServiceClient
        except ImportError as e:
            raise RuntimeError(
                f"reading {url} requires azure-storage-blob (not installed "
                "in this environment)"
            ) from e
        container, account, key = _parse_azure_url(scheme, url)
        conn = os.environ.get("AZURE_STORAGE_CONNECTION_STRING")
        if conn:
            svc = BlobServiceClient.from_connection_string(conn)
        else:
            account = account or os.environ.get("AZURE_STORAGE_ACCOUNT")
            if not account:
                raise RuntimeError(
                    f"reading {url} needs the storage account: use an "
                    "abfss://container@account.dfs.core.windows.net/path "
                    "URL or set AZURE_STORAGE_ACCOUNT / "
                    "AZURE_STORAGE_CONNECTION_STRING"
                )
            cred = os.environ.get("AZURE_STORAGE_ACCESS_KEY")
            if cred is None:
                try:
                    from azure.identity import DefaultAzureCredential

                    cred = DefaultAzureCredential()
                except ImportError:
                    cred = None  # anonymous/public access
            svc = BlobServiceClient(
                account_url=f"https://{account}.blob.core.windows.net",
                credential=cred,
            )
        blob = svc.get_blob_client(container=container, blob=key)
        return blob.download_blob().readall()
    raise RuntimeError(f"unsupported scheme {scheme!r} for {url}")


def _parse_azure_url(scheme: str, url: str) -> Tuple[str, Optional[str], str]:
    """(container, account_or_None, blob_key) from the Azure URL forms the
    reference's object_store accepts (sage-cloudpath/src/lib.rs:65-89):
    `az://container/key` (account from env) and
    `abfs[s]://container@account.dfs.core.windows.net/key`."""
    parsed = urllib.parse.urlparse(url)
    key = parsed.path.lstrip("/")
    netloc = parsed.netloc
    if "@" in netloc:
        container, host = netloc.split("@", 1)
        account = host.split(".", 1)[0]
        return container, account, key
    if "." in netloc:
        # host-style netloc (adl://account.azuredatalakestore.net/container/
        # key): the netloc is the ACCOUNT host, not a container name
        account = netloc.split(".", 1)[0]
        container, _, key = key.partition("/")
        return container, account, key
    return netloc, None, key


def read_bytes(s: str) -> bytes:
    """Read a local path or URL fully, with transparent gzip (lib.rs:65-99)."""
    scheme, loc = to_url(s)
    if scheme == "file":
        with open(loc, "rb") as f:
            raw = f.read()
    else:
        raw = _read_cloud_bytes(scheme, loc)
    if is_gzip(loc):
        raw = gzip.decompress(raw)
    return raw


def read_text(s: str) -> str:
    return read_bytes(s).decode("utf-8")


# ---------------------------------------------------------------------------
# Format dispatch (util.rs:7-72)
# ---------------------------------------------------------------------------


def file_format(path: str) -> str:
    """'mzml' | 'mgf' | 'tdf' | 'unidentified' (util.rs:30-57)."""
    p = path.lower().rstrip("/").rstrip("\\")
    if p.endswith(".mgf.gz") or p.endswith(".mgf"):
        return "mgf"
    if any(p.endswith(ext) for ext in BRUKER_EXTENSIONS):
        return "tdf"
    if p.endswith(".mzml.gz") or p.endswith(".mzml"):
        return "mzml"
    return "unidentified"


def within_file_parallel(path: str) -> bool:
    """util.rs:15-28 — TDF benefits from within-file parallelism."""
    return file_format(path) == "tdf"


def read_spectra(
    path: str,
    file_id: int = 0,
    signal_to_noise: Optional[int] = None,
    requires_ms1: bool = False,
    bruker_config: Optional[dict] = None,
):
    """Extension-dispatched spectrum reading (util.rs:59-72)."""
    fmt = file_format(path)
    if fmt == "mzml":
        scheme, loc = to_url(path)
        if scheme == "file":
            # within-file parallel parsing (self-gates to serial on small
            # files / single-core hosts)
            from .mzml import read_mzml_parallel

            return read_mzml_parallel(
                loc, file_id=file_id, signal_to_noise=signal_to_noise
            )
        from .mzml import MzMLReader

        reader = MzMLReader(file_id=file_id, signal_to_noise=signal_to_noise)
        return reader.parse(read_bytes(path))
    if fmt == "mgf":
        from .mgf import parse_mgf

        return parse_mgf(read_text(path), file_id=file_id)
    if fmt == "tdf":
        scheme, loc = to_url(path)
        if scheme != "file":
            raise RuntimeError(f"Bruker files must be local: {path}")
        from .tdf import TdfReader

        return TdfReader().parse(
            loc, file_id, config=bruker_config, requires_ms1=requires_ms1
        )
    raise ValueError(f"unable to determine file format for {path!r}")
