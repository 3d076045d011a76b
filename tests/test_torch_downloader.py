"""The port's downloader (oisat_tpu_torch.downloader) against the JAX
package's (oisat_tpu.downloader), on the CPU, with no network.

The eight downloader tests of tests/test_report_downloader.py run against the
port's module (MERRA2 URLs, ``.netrc``, the missing-earthaccess error, the
GES DISC subset flow with a stand-in session, the TEMPO offline dry run, and
``_fetch`` on a local server: resume, Content-Disposition, a Range-ignoring
server, responses closed on every path).  Parity cases give both modules the
same ``downloader(...)`` arguments and stand-ins and require the same URL
lists, requests and dry-run results (exact: strings).  The local-server
cases bind port 0, pass ``_fetch`` a short timeout and join their server
thread in a ``finally``.
"""

import contextlib
import datetime
import http.server
import json
import os
import sys
import threading

import pytest
import requests

from oisat_tpu import downloader as jax_dl
from oisat_tpu_torch import downloader as port_dl
from oisat_tpu_torch.downloader import _fetch, _setup_netrc, downloader

TIMEOUT = 10  # seconds a local-server request may take


@contextlib.contextmanager
def local_server(handler):
    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=TIMEOUT)
        assert not t.is_alive()


def file_handler(src):
    class Handler(http.server.SimpleHTTPRequestHandler):
        # SimpleHTTPRequestHandler ignores Range: always 200 + Content-Length
        def __init__(self, *a, **kw):
            super().__init__(*a, directory=str(src), **kw)

        def log_message(self, *a):
            pass

    return Handler


# ---- the eight tests of tests/test_report_downloader.py, on the port ----------

def test_merra2_urls():
    d = downloader(20, 60, -135, -55, "2019-07-01", "2019-07-03")
    urls = d.merra2_gmi("/nonexistent", dry_run=True)
    assert len(urls) == 4  # 2 days x (tac, met)
    assert urls[0] == ("https://portal.nccs.nasa.gov/datashare/merra2_gmi/Y2019/M07/"
                       "MERRA2_GMI.tavg3_3d_tac_Nv.20190701.nc4")
    assert "met_Nv.20190702" in urls[3]


def test_netrc_setup(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    _setup_netrc("alice", "secret")
    body = open(tmp_path / ".netrc").read()
    assert "machine urs.earthdata.nasa.gov login alice password secret" in body
    assert oct(os.stat(tmp_path / ".netrc").st_mode & 0o777) == "0o600"
    assert (tmp_path / ".urs_cookies").exists()
    _setup_netrc("bob", "other")  # idempotent: the entry already present stays alone
    assert open(tmp_path / ".netrc").read() == body


def test_tempo_requires_earthaccess(tmp_path, monkeypatch):
    """The twin's RuntimeError, and an ImportError naming the package."""
    monkeypatch.setitem(sys.modules, "earthaccess", None)
    d = downloader(20, 60, -135, -55, "2023-09-01", "2023-09-02")
    with pytest.raises(RuntimeError, match="earthaccess"):
        d.download_tempo_L2("NO2", tmp_path)
    with pytest.raises(ImportError, match="earthaccess") as e:
        d.download_tempo_L3("HCHO", tmp_path)
    assert e.value.name == "earthaccess"


class Resp:
    def __init__(self, payload, text=""):
        self._p = payload
        self.text = text

    def json(self):
        return self._p

    def raise_for_status(self):
        pass


class FakeGesdisc:
    """The GES DISC JSON-WSP endpoints: a subset job that runs two polls,
    then lists two result URLs; every request is recorded."""

    def __init__(self, polls_to_finish=2, final="Succeeded"):
        self.posts = []
        self.gets = []
        self.polls = 0
        self.polls_to_finish = polls_to_finish
        self.final = final

    def post(self, url, data=None, headers=None, **kw):
        req = json.loads(data)
        self.posts.append((url, req, headers))
        if req["methodname"] == "subset":
            return Resp({"result": {"jobId": "J123", "Status": "Accepted"}})
        self.polls += 1
        status = self.final if self.polls >= self.polls_to_finish else "Running"
        return Resp({"result": {"Status": status, "PercentCompleted": 50 * self.polls,
                                "jobId": "J123"}})

    def get(self, url, **kw):
        self.gets.append(url)
        assert url.endswith("J123")
        return Resp(None, text="https://host/a.nc\nhttps://host/b.nc\n")


def test_gesdisc_subset_flow(monkeypatch, tmp_path):
    fake = FakeGesdisc()
    monkeypatch.setattr(requests, "Session", lambda: fake)
    d = downloader(20, 60, -135, -55, "2019-07-01", "2019-07-31")
    monkeypatch.setattr(port_dl, "sleep", lambda s: None)
    urls = d.download_tropomi_l2("NO2", tmp_path, dry_run=True)
    assert urls == ["https://host/a.nc", "https://host/b.nc"]
    sub = fake.posts[0][1]
    assert sub["args"]["data"][0]["datasetId"] == "S5P_L2__NO2____HiR_2"
    assert sub["args"]["box"] == [-135, 20, -55, 60]
    assert sub["args"]["start"].startswith("2019-07-01T00:00:00")
    assert fake.posts[1][1]["methodname"] == "GetStatus"


def test_fetch_resume_with_local_server(tmp_path):
    """Full download, then resume from a partial file against a server that
    ignores Range: the client must see the 200 and restart cleanly."""
    src = tmp_path / "srv"
    src.mkdir()
    payload = bytes(range(256)) * 40  # 10240 bytes
    (src / "granule.nc").write_bytes(payload)
    with local_server(file_handler(src)) as base:
        out = tmp_path / "dl"
        dest = _fetch(f"{base}/granule.nc", out, timeout=TIMEOUT)
        assert dest.read_bytes() == payload
        dest.write_bytes(payload[:1000])
        assert _fetch(f"{base}/granule.nc", out, timeout=TIMEOUT).read_bytes() == payload


def test_fetch_honours_content_disposition(tmp_path):
    """GES DISC subset links share path basenames; the served filename in
    Content-Disposition must win or granules overwrite each other."""

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            name = "granule_A.nc" if "id=1" in self.path else "granule_B.nc"
            body = name.encode() * 10
            self.send_response(200)
            self.send_header("Content-Disposition", f'attachment; filename="{name}"')
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    with local_server(Handler) as base:
        out = tmp_path / "dl"
        d1 = _fetch(f"{base}/HTTP_services.cgi?id=1", out, timeout=TIMEOUT)
        d2 = _fetch(f"{base}/HTTP_services.cgi?id=2", out, timeout=TIMEOUT)
        assert d1.name == "granule_A.nc" and d2.name == "granule_B.nc"
        assert d1.read_bytes() != d2.read_bytes()


class FakeGranule:
    def __init__(self, name):
        self._name = name

    def data_links(self):
        return [f"https://asdc.larc.nasa.gov/tempo/{self._name}"]


class FakeEarthaccess:
    def __init__(self):
        self.downloads = []
        self.searches = []
        self.logins = 0

    def login(self):
        self.logins += 1

    def search_data(self, **kw):
        self.searches.append(kw)
        return [FakeGranule(f"{kw['short_name']}_V03_20240101T120000Z.nc"),
                FakeGranule(f"{kw['short_name']}_V03_20240101T130000Z.nc")]

    def download(self, granule, local_path):
        self.downloads.append((granule._name, local_path))


def test_tempo_dry_run_offline(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))  # _setup_netrc writes under tmp_path
    d = downloader(25.0, 50.0, -125.0, -65.0, "2024-01-01", "2024-01-02")
    fake = FakeEarthaccess()
    links = d.download_tempo_L2("NO2", tmp_path, dry_run=True, earthaccess_mod=fake)
    assert len(links) == 2 and links[0].endswith("T120000Z.nc")
    assert fake.downloads == []  # dry_run listed, did not fetch
    kw = fake.searches[0]
    assert kw["short_name"] == "TEMPO_NO2_L2"
    assert kw["bounding_box"] == (-125.0, 25.0, -65.0, 50.0)
    assert kw["temporal"] == ("2024-01-01 00:00:00", "2024-01-02 23:59:59")
    d.download_tempo_L3("HCHO", tmp_path, earthaccess_mod=fake)
    assert len(fake.downloads) == 2
    assert fake.searches[1]["short_name"] == "TEMPO_HCHO_L3"
    with pytest.raises(ValueError, match="unsupported TEMPO"):
        d.download_tempo_L2("CHEESE", tmp_path, earthaccess_mod=fake)


def test_fetch_complete_file_not_redownloaded_on_range_ignoring_server(tmp_path):
    """A server that ignores Range but sends Content-Length: an already
    complete local file is detected by the length and not rewritten."""
    src = tmp_path / "srv"
    src.mkdir()
    payload = b"x" * 4096
    (src / "granule.nc").write_bytes(payload)
    with local_server(file_handler(src)) as base:
        out = tmp_path / "dl"
        dest = _fetch(f"{base}/granule.nc", out, timeout=TIMEOUT)
        assert dest.read_bytes() == payload
        sentinel = b"y" * 4096  # same size: a re-download would revert it
        dest.write_bytes(sentinel)
        dest2 = _fetch(f"{base}/granule.nc", out, timeout=TIMEOUT)
        assert dest2 == dest and dest2.read_bytes() == sentinel


def test_fetch_closes_responses_on_all_paths(tmp_path):
    class FakeResp:
        def __init__(self, status, body=b"", headers=None, explode=False):
            self.status_code = status
            self.headers = headers or {}
            self._body = body
            self._explode = explode
            self.closed = False

        def raise_for_status(self):
            if self.status_code >= 400:
                raise OSError(f"http {self.status_code}")

        def iter_content(self, n):
            if self._explode:
                raise OSError("mid-stream reset")
            yield self._body

        def close(self):
            self.closed = True

    class FakeSession:
        def __init__(self, resps):
            self.resps = list(resps)
            self.seen = []

        def get(self, url, **kw):
            r = self.resps.pop(0)
            self.seen.append(r)
            return r

    (tmp_path / "a").mkdir()
    (tmp_path / "a" / "g.nc").write_bytes(b"partial")
    s = FakeSession([FakeResp(403)])  # error on the ranged probe's status check
    with pytest.raises(OSError):
        _fetch("http://x/g.nc", tmp_path / "a", session=s)
    assert all(r.closed for r in s.seen)
    (tmp_path / "b").mkdir()
    s = FakeSession([FakeResp(200, explode=True)])  # error mid-stream
    with pytest.raises(OSError):
        _fetch("http://x/h.nc", tmp_path / "b", session=s)
    assert all(r.closed for r in s.seen)
    s = FakeSession([FakeResp(200, body=b"data")])  # the happy path frees it too
    assert _fetch("http://x/i.nc", tmp_path / "b", session=s).read_bytes() == b"data"
    assert all(r.closed for r in s.seen)


# ---- parity: the same arguments give the JAX module's results -------------------

WINDOWS = [(20, 60, -135, -55, "2019-07-01", "2019-07-03"),
           (-90, 90, -180, 180, "2019-12-30", "2020-01-02"),
           (25.0, 50.0, -125.0, -65.0, "2024-02-27", "2024-03-02")]


@pytest.mark.parametrize("window", WINDOWS)
def test_merra2_url_lists_are_the_twins(window):
    got = downloader(*window).merra2_gmi("/nonexistent", dry_run=True)
    assert got == jax_dl.downloader(*window).merra2_gmi("/nonexistent", dry_run=True)
    start, end = (datetime.date.fromisoformat(s) for s in window[4:])
    assert len(got) == 2 * (end - start).days


@pytest.mark.parametrize("method,tag,name", [
    ("download_tropomi_l2", "NO2", None), ("download_tropomi_l2", "HCHO", None),
    ("download_tropomi_l2", "NO2", "S5P_L2__NO2____HiR_1"),
    ("download_omi_l2", "NO2", None), ("download_omi_l2", "HCHO", None),
    ("download_omi_l2", "O3", None), ("download_ssmis", "WV", None),
    ("download_ssmis", "WV", "rssmif17m")])
def test_gesdisc_requests_are_the_twins(monkeypatch, tmp_path, method, tag, name):
    """Every GES DISC route sends the twin's subset and status requests,
    to the same endpoints, and returns the same dry-run URL list."""
    out = {}
    for key, mod in (("jax", jax_dl), ("port", port_dl)):
        fake = FakeGesdisc()
        monkeypatch.setattr(requests, "Session", lambda fake=fake: fake)
        monkeypatch.setattr(mod, "sleep", lambda s: None)
        d = mod.downloader(20, 60, -135, -55, "2019-07-01", "2019-07-31")
        urls = getattr(d, method)(tag, tmp_path, product_name=name, dry_run=True)
        out[key] = (urls, fake.posts, fake.gets)
    assert out["port"] == out["jax"]
    assert out["port"][0] == ["https://host/a.nc", "https://host/b.nc"]
    assert len(out["port"][1]) == 3  # the subset, two polls


def test_gesdisc_failed_job_and_fault_are_the_twins(monkeypatch, tmp_path):
    for mod in (jax_dl, port_dl):
        monkeypatch.setattr(mod, "sleep", lambda s: None)
        d = mod.downloader(20, 60, -135, -55, "2019-07-01", "2019-07-31")
        monkeypatch.setattr(requests, "Session", lambda: FakeGesdisc(final="Failed"))
        with pytest.raises(RuntimeError, match="GES-DISC job failed"):
            d.download_omi_l2("NO2", tmp_path, dry_run=True)

        class Fault(FakeGesdisc):
            def post(self, url, data=None, headers=None, **kw):
                return Resp({"type": "jsonwsp/fault", "fault": {"string": "bad box"}})

        monkeypatch.setattr(requests, "Session", lambda: Fault())
        with pytest.raises(RuntimeError, match="bad box"):
            d.download_omi_l2("NO2", tmp_path, dry_run=True)
        with pytest.raises(ValueError, match="unsupported OMI"):
            d.download_omi_l2("CHEESE", tmp_path)
        with pytest.raises(ValueError, match="unsupported TROPOMI"):
            d.download_tropomi_l2("CHEESE", tmp_path)


@pytest.mark.parametrize("method,tag", [("download_tempo_L2", "NO2"), ("download_tempo_L2", "HCHO"),
                                        ("download_tempo_L3", "NO2"), ("download_tempo_L3", "HCHO")])
def test_tempo_dry_run_and_download_are_the_twins(tmp_path, monkeypatch, method, tag):
    monkeypatch.setenv("HOME", str(tmp_path))
    out = {}
    for key, mod in (("jax", jax_dl), ("port", port_dl)):
        d = mod.downloader(25.0, 50.0, -125.0, -65.0, "2024-01-01", "2024-01-02")
        fake = FakeEarthaccess()
        listed = getattr(d, method)(tag, tmp_path, dry_run=True, earthaccess_mod=fake)
        fetched = getattr(d, method)(tag, tmp_path, earthaccess_mod=fake)
        out[key] = (listed, fetched, fake.searches, fake.downloads, fake.logins)
    assert out["port"] == out["jax"]
    assert len(out["port"][3]) == 2 and out["port"][4] == 2


LISTING = ('<html><body><a href="../">up</a><a href="MOP03J-20190701-L3V95.9.3.he5">g</a>'
           '<a href="MOP03J-20190701-L3V95.9.3.he5.xml">x</a>'
           '<a href="OMI-Aura_L2-OMHCHO_2019m0701t0040-o79391.nc">h</a>'
           '<a href="OMI-Aura_L2-OMHCHO_2019m0701t0219-o79392.he5">h5</a><a>no href</a>'
           '</body></html>')


@pytest.mark.parametrize("method", ["download_mopitt_l2", "omi_hcho_cfa"])
def test_directory_listings_are_the_twins(monkeypatch, tmp_path, method):
    """The bs4 routes parse the same listing into the same URLs (``get``
    stands in for the archive's directory pages)."""
    out = {}
    for key, mod in (("jax", jax_dl), ("port", port_dl)):
        pages = []

        def get(url, **kw):
            pages.append(url)
            return Resp(None, text=LISTING)

        monkeypatch.setattr(requests, "get", get)
        d = mod.downloader(20, 60, -135, -55, "2019-07-01", "2019-07-03")
        out[key] = (getattr(d, method)(tmp_path, dry_run=True), pages)
    assert out["port"] == out["jax"]
    urls, pages = out["port"]
    assert len(pages) == 2 and urls and all(u.startswith(pages[0][:30]) for u in urls)


@pytest.mark.parametrize("header,name", [
    (None, None), ('attachment; filename="a.nc"', "a.nc"), ("attachment; filename=b.he5", "b.he5"),
    ("attachment; filename*=UTF-8''c.nc4", "UTF-8''c.nc4"), ('inline; filename="../../etc/d.nc"', "d.nc"),
    ("inline", None)])
def test_disposition_filename_is_the_twins(header, name):
    assert port_dl._disposition_filename(header) == jax_dl._disposition_filename(header) == name


def test_fetch_resumes_with_range_on_a_server_that_honours_it(tmp_path):
    """A partial file resumed with a 206 (appended, not rewritten) and a
    complete one answered 416: one ranged request each."""
    payload = bytes(range(200)) * 30
    seen = []

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            rng = self.headers.get("Range")
            seen.append((rng, self.headers.get("Accept-Encoding")))
            start = int(rng[len("bytes="):-1]) if rng else 0
            if start >= len(payload):
                self.send_response(416)
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            body = payload[start:]
            self.send_response(206 if rng else 200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    with local_server(Handler) as base:
        for key, fetch in (("jax", jax_dl._fetch), ("port", _fetch)):
            out = tmp_path / key
            out.mkdir()
            (out / "granule.nc").write_bytes(payload[:1234])
            dest = fetch(f"{base}/granule.nc", out, timeout=TIMEOUT)
            assert dest.read_bytes() == payload
            assert fetch(f"{base}/granule.nc", out, timeout=TIMEOUT) == dest
    want = [("bytes=1234-", "identity"), (f"bytes={len(payload)}-", "identity")]
    assert seen == want * 2
