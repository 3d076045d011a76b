"""Data acquisition: region+date-windowed fetchers for every input product.

Twin of ``oisat_tpu/downloader.py:20-380`` (reference
oisatgmi/downloader.py:40-601), a copy for the port: ``downloader(latll,
latur, lonll, lonur, datestart, dateend)`` with per-archive methods, one
shared GES-DISC JSON-WSP subset workflow, one netrc helper, resumable
downloads through ``requests`` streaming with Range headers (the reference
shells out to ``wget --continue``), and a ``dry_run`` mode on every fetcher
that returns the URL list without fetching (also how the tests exercise
this module with no network).

``requests``, ``bs4`` and ``earthaccess`` are imported inside the methods
that use them, so the module imports where they are absent and such a call
raises ImportError naming the package.  The TEMPO methods accept an
``earthaccess_mod`` injection seam (any object with login/search_data/
download) so the route is testable offline -- its listing itself goes
through the earthaccess search API, so unlike the GES-DISC routes there is
no plain-URL fallback.
"""

from __future__ import annotations

import datetime
import json
import os
from pathlib import Path
from time import sleep

__all__ = ["downloader"]

GESDISC_SUBSET_URL = "https://disc.gsfc.nasa.gov/service/subset/jsonwsp"
GESDISC_RESULTS_URL = "https://disc.gsfc.nasa.gov/api/jobs/results/"


class _MissingEarthaccess(ImportError, RuntimeError):
    """earthaccess is absent: an ImportError, as for ``requests`` and
    ``bs4``, and the RuntimeError the twin raises, so callers of either
    package catch it alike."""


def _daterange(start_date, end_date):
    for n in range(int((end_date - start_date).days)):
        yield start_date + datetime.timedelta(n)


def _setup_netrc(username, password):
    """Earthdata login via ~/.netrc (reference downloader.py:146-156).
    Idempotent: a machine entry already present is left untouched (the
    reference appended blindly, growing duplicate credential lines)."""
    if username is None or password is None:
        return
    netrc = os.path.expanduser("~/.netrc")
    if os.path.exists(netrc):
        with open(netrc) as f:
            if "machine urs.earthdata.nasa.gov" in f.read():
                return
    line = f"machine urs.earthdata.nasa.gov login {username} password {password}\n"
    with open(netrc, "a") as f:
        f.write(line)
    os.chmod(netrc, 0o600)
    open(os.path.expanduser("~/.urs_cookies"), "a").close()


def _disposition_filename(cd: str | None):
    """Filename from a Content-Disposition header, if any."""
    if not cd:
        return None
    import re

    m = re.search(r'filename\*?=(?:"([^"]+)"|([^;\s]+))', cd)
    if not m:
        return None
    name = (m.group(1) or m.group(2)).strip().strip("'\"")
    return os.path.basename(name) or None


# Downloads always ask for the identity transfer encoding: with requests'
# default Accept-Encoding: gzip, Content-Length is the *compressed* entity
# size while iter_content writes decoded bytes, so the size==Content-Length
# completeness checks below could never fire (and Range offsets into the
# compressed stream would be incoherent).  The payloads are HDF/netCDF —
# already compressed — so identity costs nothing.
_IDENTITY = {"Accept-Encoding": "identity"}


def _is_complete(path: Path, response) -> bool:
    """True when ``path``'s size equals the response's Content-Length —
    the same complete-file test ``wget --continue`` applies.  Note the
    wget-parity consequence: a file regenerated upstream with identical
    byte length is treated as already-downloaded (the reference's
    ``wget --continue`` fetchers, e.g. reference downloader.py:205,429,
    behave the same way); delete the local file to force a refresh."""
    total = response.headers.get("Content-Length")
    return total is not None and path.stat().st_size == int(total)


def _fetch(url, output_fld: Path, session=None, timeout=600):
    """Resumable streamed download (the wget --continue role).

    The destination name honours Content-Disposition when the server sends
    one — GES-DISC subset results are HTTP_services.cgi-style links whose
    path basenames collide, which is exactly why the reference passed
    ``wget --content-disposition`` (reference downloader.py:568-576);
    naming from the URL path would overwrite one granule with the next."""
    import requests

    session = session or requests.Session()
    output_fld = Path(output_fld)
    output_fld.mkdir(parents=True, exist_ok=True)
    url_name = url.rstrip("/").split("/")[-1].split("?")[0]
    guess = output_fld / url_name if url_name else None
    r = None
    dest = None
    mode = "wb"
    # Every exit (return, raise_for_status, mid-stream exception) must free
    # the streamed response, or the shared session's pooled connection stays
    # checked out until GC — a campaign retry loop pins sockets.  The
    # finally closes whichever response is live; replacement sites close the
    # old one before reassigning.
    try:
        if guess is not None and guess.exists() and guess.stat().st_size > 0:
            # Range-first probe (the wget --continue shape): when the
            # URL-named file already exists, a 416 proves it complete
            # without a throwaway full GET — the only complete-file signal
            # a server without Content-Length ever gives
            r = session.get(url,
                            headers={"Range": f"bytes={guess.stat().st_size}-",
                                     **_IDENTITY},
                            stream=True, timeout=timeout)
            if r.status_code == 416:  # already complete
                return guess
            r.raise_for_status()
            name = _disposition_filename(r.headers.get("Content-Disposition"))
            if name is None or name == url_name:
                dest = guess
                if r.status_code == 206:
                    mode = "ab"
                else:  # 200: Range ignored
                    if _is_complete(guess, r):
                        return guess  # already complete, server can't 416
                    mode = "wb"
            else:
                # server names the file differently (Content-Disposition):
                # the ranged offset was computed against the wrong file —
                # restart with the normal full-GET flow below
                r.close()
                r = None
        if r is None:
            r = session.get(url, stream=True, timeout=timeout,
                            headers=_IDENTITY)
            r.raise_for_status()
            fname = (_disposition_filename(r.headers.get("Content-Disposition"))
                     or url_name)
            dest = output_fld / fname
            if dest.exists():
                if _is_complete(dest, r):
                    return dest  # already complete
                # partial file: retry with a Range header (wget --continue)
                r.close()
                r = session.get(url,
                                headers={"Range": f"bytes={dest.stat().st_size}-",
                                         **_IDENTITY},
                                stream=True, timeout=timeout)
                if r.status_code == 416:  # already complete
                    return dest
                r.raise_for_status()
                # 200 below means the server ignored Range
                mode = "ab" if r.status_code == 206 else "wb"
        with open(dest, mode) as f:
            for chunk in r.iter_content(1 << 20):
                f.write(chunk)
        return dest
    finally:
        if r is not None:
            r.close()


class downloader:
    """Region + date-window data fetchers (reference downloader.py:40-57)."""

    def __init__(self, latll, latur, lonll, lonur, datestart: str, dateend: str):
        self.latll = latll
        self.latur = latur
        self.lonll = lonll
        self.lonur = lonur
        self.datestart = datestart
        self.dateend = dateend

    # -- shared GES-DISC subset workflow ------------------------------------
    def _gesdisc_subset(self, dataset_id: str, output_fld: Path, dry_run=False,
                        poll_seconds=5.0):
        """Submit a JSON-WSP subset job, poll, fetch the result URLs
        (reference downloader.py:157-219, :318-404, :528-587).

        ``poll_seconds`` defaults to the reference's 5 s cadence (tests
        pass a small value); subset jobs run minutes, so a sub-second
        default would hammer the jobs API."""
        import requests

        session = requests.Session()  # one auth/redirect dance for the batch
        request = {
            "methodname": "subset",
            "type": "jsonwsp/request",
            "version": "1.0",
            "args": {"role": "subset",
                     "start": self.datestart + "T00:00:00.000Z",
                     "end": self.dateend + "T23:59:59.999Z",
                     "box": [self.lonll, self.latll, self.lonur, self.latur],
                     "data": [{"datasetId": dataset_id}]},
        }
        hdrs = {"Content-Type": "application/json", "Accept": "application/json"}

        def post(payload):
            resp = session.post(GESDISC_SUBSET_URL, data=json.dumps(payload),
                                headers=hdrs, timeout=120).json()
            if resp.get("type") == "jsonwsp/fault" or "result" not in resp:
                # surface the API's own error message (reference
                # downloader.py:26-32 _get_http_data fault check)
                raise RuntimeError(f"GES-DISC API fault: {resp}")
            return resp

        resp = post(request)
        job_id = resp["result"]["jobId"]
        status_request = {"methodname": "GetStatus", "version": "1.0",
                          "type": "jsonwsp/request", "args": {"jobId": job_id}}
        while resp["result"]["Status"] in ("Accepted", "Running"):
            sleep(poll_seconds)
            resp = post(status_request)
            print("Job status: %s (%d%% complete)" %
                  (resp["result"]["Status"], resp["result"].get("PercentCompleted", 0)))
        if resp["result"]["Status"] != "Succeeded":
            raise RuntimeError(f"GES-DISC job failed: {resp['result']}")
        urls = [u.strip() for u in session.get(GESDISC_RESULTS_URL + job_id,
                                               timeout=120).text.split("\n")
                if u.strip()]
        if dry_run:
            return urls
        for url in urls:
            _fetch(url, output_fld, session=session)
        return urls

    # -- per-product methods --------------------------------------------------
    def download_tropomi_l2(self, product_tag: str, output_fld: Path,
                            product_name=None, username=None, password=None,
                            dry_run=False):
        """TROPOMI L2 via GES-DISC (reference downloader.py:133-219)."""
        _setup_netrc(username, password)
        product = {"NO2": "S5P_L2__NO2____HiR_2", "HCHO": "S5P_L2__HCHO___HiR_2"}.get(product_tag)
        if product_name is not None:
            product = product_name
        if product is None:
            raise ValueError(f"unsupported TROPOMI product {product_tag}")
        return self._gesdisc_subset(product, output_fld, dry_run=dry_run)

    def download_omi_l2(self, product_tag: str, output_fld: Path, product_name=None,
                        username=None, password=None, dry_run=False):
        """OMI L2 via GES-DISC (reference downloader.py:318-404)."""
        _setup_netrc(username, password)
        # dataset ids per reference downloader.py:329-336
        product = {"NO2": "OMI_MINDS_NO2_1.1", "HCHO": "OMHCHO_003",
                   "O3": "OMTO3_003"}.get(product_tag)
        if product_name is not None:
            product = product_name
        if product is None:
            raise ValueError(f"unsupported OMI product {product_tag}")
        return self._gesdisc_subset(product, output_fld, dry_run=dry_run)

    def download_ssmis(self, product_tag: str, output_fld: Path, product_name=None,
                       username=None, password=None, dry_run=False):
        """SSMIS monthly WV via GES-DISC (reference downloader.py:505-587)."""
        _setup_netrc(username, password)
        return self._gesdisc_subset(product_name or "rssmif16m", output_fld, dry_run=dry_run)

    def _tempo_earthaccess(self, short_name: str, output_fld: Path,
                           username=None, password=None, version="V03",
                           dry_run=False, earthaccess_mod=None):
        """TEMPO via earthaccess (reference downloader.py:219-316).

        ``dry_run=True`` runs the search and returns the granule data
        links without downloading.  ``earthaccess_mod`` injects a stand-in
        for the earthaccess module (login/search_data/download) so the
        route is exercisable offline."""
        ea = earthaccess_mod
        if ea is None:
            try:
                import earthaccess as ea
            except ImportError as e:
                raise _MissingEarthaccess(
                    "earthaccess is not installed; TEMPO downloads need it "
                    "(pip install earthaccess)", name="earthaccess") from e
        _setup_netrc(username, password)
        ea.login()
        results = ea.search_data(
            short_name=short_name, version=version,
            temporal=(self.datestart + " 00:00:00", self.dateend + " 23:59:59"),
            bounding_box=(self.lonll, self.latll, self.lonur, self.latur))
        links = [r.data_links()[0] for r in results]
        if dry_run:
            return links
        for r, link in zip(results, links):
            print(link.split("/")[-1])
            ea.download(r, local_path=str(output_fld))
        return links

    def download_tempo_L2(self, product_tag: str, output_fld: Path, product_name=None,
                          username=None, password=None, dry_run=False,
                          earthaccess_mod=None):
        short = product_name or {"NO2": "TEMPO_NO2_L2",
                                 "HCHO": "TEMPO_HCHO_L2"}.get(product_tag)
        if short is None:
            raise ValueError(f"unsupported TEMPO L2 product {product_tag}")
        return self._tempo_earthaccess(short, output_fld, username, password,
                                       dry_run=dry_run,
                                       earthaccess_mod=earthaccess_mod)

    def download_tempo_L3(self, product_tag: str, output_fld: Path, product_name=None,
                          username=None, password=None, dry_run=False,
                          earthaccess_mod=None):
        short = product_name or {"NO2": "TEMPO_NO2_L3",
                                 "HCHO": "TEMPO_HCHO_L3"}.get(product_tag)
        if short is None:
            raise ValueError(f"unsupported TEMPO L3 product {product_tag}")
        return self._tempo_earthaccess(short, output_fld, username, password,
                                       dry_run=dry_run,
                                       earthaccess_mod=earthaccess_mod)

    def download_mopitt_l2(self, output_fld: Path, dry_run=False):
        """MOPITT L3 via the LaRC OPeNDAP directory listing
        (reference downloader.py:406-435)."""
        import requests
        from bs4 import BeautifulSoup

        start = datetime.date.fromisoformat(self.datestart)
        end = datetime.date.fromisoformat(self.dateend)
        urls = []
        for day in _daterange(start, end):
            base = (f"https://opendap.larc.nasa.gov/opendap/MOPITT/MOP03J.009/"
                    f"{day.year}.{day.month:02}.{day.day:02}/")
            soup = BeautifulSoup(requests.get(base).text, "html.parser")
            for link in soup.find_all("a"):
                href = link.get("href") or ""
                if href.startswith("MOP03J") and href.endswith("he5"):
                    urls.append(base + href)
        urls = sorted(set(urls))
        if not dry_run:
            for url in urls:
                _fetch(url, output_fld)
        return urls

    def merra2_gmi(self, output_fld: Path, dry_run=False):
        """MERRA2-GMI day files from the NCCS datashare portal
        (reference downloader.py:437-474)."""
        start = datetime.date.fromisoformat(self.datestart)
        end = datetime.date.fromisoformat(self.dateend)
        urls = []
        for day in _daterange(start, end):
            for coll in ("tavg3_3d_tac_Nv", "tavg3_3d_met_Nv"):
                urls.append(
                    "https://portal.nccs.nasa.gov/datashare/merra2_gmi/"
                    f"Y{day.year}/M{day.month:02}/MERRA2_GMI.{coll}."
                    f"{day.year}{day.month:02}{day.day:02}.nc4")
        if not dry_run:
            for url in urls:
                _fetch(url, output_fld)
        return urls

    def omi_hcho_cfa(self, output_fld: Path, dry_run=False):
        """OMI-HCHO from the SAO archive directory listing
        (reference downloader.py:476-503)."""
        import requests
        from bs4 import BeautifulSoup

        start = datetime.date.fromisoformat(self.datestart)
        end = datetime.date.fromisoformat(self.dateend)
        urls = []
        for day in _daterange(start, end):
            base = ("https://waps.cfa.harvard.edu/sao_atmos/data/omi_hcho/OMI-HCHO-L2/"
                    f"{day.year}/{day.month:02}/{day.day:02}/")
            soup = BeautifulSoup(requests.get(base).text, "html.parser")
            for link in soup.find_all("a"):
                href = link.get("href") or ""
                if href.endswith(".nc") or href.endswith(".he5"):
                    urls.append(base + href)
        if not dry_run:
            for url in urls:
                _fetch(url, output_fld)
        return urls
