# mirrors npge_tpu/io/getdata.py
"""GetData — fetch genome FASTA by accession over HTTP.

Equivalent of the reference's ``GetData`` processor (``src/algo/GetData.cpp``
⚠[B], SURVEY.md §2.3): download the accessions listed in ``genomes.tsv``
from ENA/NCBI before Prepare. The URL template is configurable (the
``NPGE_FASTA_URL`` environment variable or the ``url_template`` argument,
with ``{acc}`` substituted), defaulting to the ENA browser API the
reference uses. This build environment has no network egress, so the
default endpoint is unreachable here; the code path is exercised in tests
against a local HTTP server (tests/test_io.py), and works unchanged
wherever egress exists.
"""

from __future__ import annotations

import os
import re
import shutil
import urllib.request

DEFAULT_URL = "https://www.ebi.ac.uk/ena/browser/api/fasta/{acc}"

# genomes.tsv files are commonly shared artifacts: reject anything that
# could escape --data-dir via os.path.join ('/', '..') or inject into the
# URL template (round-4 advisor finding). Real ENA/NCBI accessions are
# alphanumeric with dots/underscores/dashes.
_ACC_RE = re.compile(r"^[A-Za-z0-9._-]+$")


def _check_accession(acc: str) -> str:
    if not _ACC_RE.match(acc) or acc in (".", "..") or acc.startswith("."):
        raise SystemExit(
            f"getdata: invalid accession {acc!r} (allowed: letters, digits,"
            " '.', '_', '-'; must not start with '.')"
        )
    return acc


def fetch_accession(
    acc: str,
    dest_dir: str,
    url_template: str | None = None,
    timeout: float = 120.0,
) -> str:
    """Download one accession's FASTA into ``dest_dir/<acc>.fa``; returns
    the file path. Raises urllib.error.URLError on network failure."""
    _check_accession(acc)
    url = (
        url_template
        or os.environ.get("NPGE_FASTA_URL")
        or DEFAULT_URL
    ).format(acc=acc)
    os.makedirs(dest_dir, exist_ok=True)
    dest = os.path.join(dest_dir, acc + ".fa")
    tmp = dest + ".part"
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r, open(
            tmp, "wb"
        ) as f:
            shutil.copyfileobj(r, f)
        os.replace(tmp, dest)
    except BaseException:
        if os.path.exists(tmp):  # no stale partial downloads
            os.unlink(tmp)
        raise
    return dest


def fetch_missing(
    accessions: list[str],
    dest_dir: str,
    url_template: str | None = None,
) -> list[str]:
    """Fetch every accession without a local FASTA; returns the fetched
    paths (already-present accessions are skipped)."""
    out = []
    for acc in accessions:
        _check_accession(acc)
        have = any(
            os.path.exists(os.path.join(dest_dir, acc + ext))
            for ext in (".fa", ".fasta", ".fa.gz", ".fasta.gz")
        )
        if not have:
            out.append(fetch_accession(acc, dest_dir, url_template))
    return out
