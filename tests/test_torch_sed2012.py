"""Slice 2g's data tier against the JAX package: ``data/sed2012`` (no pandas)
and the reference's sketch-benchmark stream.

  * ``prepare_modalities`` orders rows with tied upload times exactly as the
    JAX package's ``df.sort_values(by="dateupload")`` does (pandas' unstable
    quicksort over the non-NaN values, NaN rows last in their original
    order): bit-equal for every label mode, both sort flags and noise rates
    0.05 / 0.95 / 1.0, through ``data/sed2012`` and through
    ``data/synthetic`` (which delegates to it);
  * the loader: on the XML fixtures of ``tests/test_sed2012_loader.py`` the
    port's column table equals the JAX DataFrame column by column, on the
    native scanner and on the Python iterparse path, bounded and skipped
    parses included, and ``load_sed2012_dataset`` equals it with labels and
    timestamps;
  * ``convert_timestamp_column`` equals the JAX package's on both its paths;
  * ``synthetic_stream`` / ``load_synthetic_dataset`` equal the JAX package's.
"""
import random
import time
from xml.sax.saxutils import escape

import numpy as np
import pandas as pd
import pytest

from mused_tpu.data import sed2012 as jsed
from mused_tpu.data import synthetic as jsyn
from mused_tpu_torch import native as tnative
from mused_tpu_torch.data import sed2012 as tsed
from mused_tpu_torch.data import synthetic as tsyn
from test_sed2012_loader import EVIL_XML, GNARLY_XML, XML
from torch_parity import assert_table_equals_frame, table_from_dataframe

COMMENTS_XML = """<photos>
  <!-- preamble <photo id="666" dateTaken="x"> not a record -->
  <photo username="see id='9' here" id="1000000001" dateTaken="2012-01-01 01:01:01.0" dateUploaded="2012-01-01 02:01:01.0">
    <title>foo <!-- gone --> bar</title>
    <location latitude="0x10" longitude="0x10"/>
    <tags><tag>alpha</tag><!-- <tag>ghost</tag> --><tag>beta</tag></tags>
  </photo>
  <photo id="1000000002" dateTaken="2012-01-02 01:01:01.0" dateUploaded="2012-01-02 02:01:01.0" username="bob">
    <location latitude="2.25" longitude="41.39"/>
  </photo>
</photos>
"""


def _fuzz_xml(n: int = 120) -> str:
    """Random text (unicode, HTML-ish spans, entities) through escaping."""
    rng = random.Random(0)
    alphabet = (list("abcXYZ019 <>&\"'\t\n\r.,!?-_/") +
                ["é", "ß", "中", "\xa0", " ", "<b>", "</b>", "&amp;", "tag>", "<", ">"])
    parts = ['<?xml version="1.0" encoding="UTF-8"?>\n<photos>\n']
    for i in range(n):
        txt = "".join(rng.choice(alphabet) for _ in range(rng.randint(0, 60)))
        tag = "".join(rng.choice(alphabet) for _ in range(rng.randint(1, 12)))
        parts.append(f'<photo id="{i}" dateTaken="2012-01-01 00:00:00.0" '
                     f'dateUploaded="2012-01-01 01:00:00.0" username="u{i}">'
                     f'<title>{escape(txt)}</title><description>{escape(txt[::-1])}'
                     f'</description><tags><tag>{escape(tag)}</tag></tags></photo>\n')
    return "".join(parts) + "</photos>\n"


FIXTURES = {"reference": XML, "gnarly": GNARLY_XML, "hostile": EVIL_XML,
            "comments_floats": COMMENTS_XML, "fuzz": _fuzz_xml()}


@pytest.fixture(scope="module")
def tied_frame():
    """A table whose upload times tie in runs (whole seconds, as SED2012's
    do) with 1% NaN, three label columns and every modality."""
    rng = np.random.default_rng(11)
    n = 3000
    up = (1.3e9 + rng.integers(0, 60, n)).astype(np.float64)
    up[rng.random(n) < 0.01] = np.nan
    eid = np.where(rng.random(n) < 0.5, 0, rng.integers(1, 9, n))
    lat = rng.normal(size=n)
    lat[rng.random(n) < 0.1] = np.nan
    df = pd.DataFrame({
        "id": np.arange(n), "datetaken": up - rng.integers(0, 100, n),
        "dateupload": up, "latitude": lat, "longitude": rng.normal(size=n),
        "title": [f"t{i}" for i in range(n)], "description": [f"d {i % 17}" for i in range(n)],
        "tags": [[f"a{i % 7}", "b"][: i % 3] for i in range(n)],
        "username": [f"u{i % 13}" for i in range(n)], "event_id": eid})
    df["is_event"] = (eid > 0).astype(int)
    df["event_type"] = np.where(eid == 0, 0, (eid - 1) % 3 + 1)
    return df


def _modalities_equal(got, want) -> None:
    (gm, gt, gl), (wm, wt, wl) = got, want
    assert gt == wt
    assert gl.dtype == wl.dtype
    np.testing.assert_array_equal(gl, wl)
    for g, w in zip(gm, wm):
        assert g.shape == w.shape and g.dtype == w.dtype
        if w.dtype.kind == "f":
            np.testing.assert_array_equal(g, w)     # NaN in the same places
        else:
            assert g.tolist() == w.tolist()


@pytest.mark.parametrize("entry", ["sed2012", "synthetic"])
@pytest.mark.parametrize("noise_rate", [0.05, 0.95, 1.0])
@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("label_mode", ["binary", "types", "all"])
def test_prepare_modalities_orders_tied_upload_times_like_pandas(
        tied_frame, entry, noise_rate, sort, label_mode):
    kw = dict(sort_by_uploaded=sort, binary=label_mode == "binary",
              event_types=label_mode != "all", noise_rate=noise_rate, seed=5)
    want = jsed.prepare_modalities(tied_frame, subset_size=1200, **kw)
    table = table_from_dataframe(tied_frame)
    fn = tsed.prepare_modalities if entry == "sed2012" else tsyn.prepare_modalities
    _modalities_equal(fn(table, 1200, **kw), want)


def test_upload_order_is_pandas_sort_values(tied_frame):
    want = tied_frame.sort_values(by="dateupload").index.to_numpy()
    np.testing.assert_array_equal(tsed.upload_order(tied_frame["dateupload"].to_numpy()),
                                  want)


@pytest.mark.parametrize("use_native", [False, True])
@pytest.mark.parametrize("name", list(FIXTURES))
def test_parse_metadata_matches_jax_frame(name, use_native, tmp_path):
    if use_native:
        assert tnative.sed_available(), tnative.sed_load_error
    p = tmp_path / "m.xml"
    p.write_text(FIXTURES[name])
    gt = {"42": 7, "1000000003": 2}
    before = tnative.sed_calls
    got = tsed.parse_metadata(str(p), gt, use_native=use_native)
    assert tnative.sed_calls == before + int(use_native)
    assert_table_equals_frame(got, jsed.parse_metadata(str(p), gt, use_native=False))


@pytest.fixture
def dataset_dir(tmp_path):
    d = tmp_path / "sed2012"
    d.mkdir()
    (d / "sed2012_metadata.xml").write_text(XML)
    (d / "technical_events.txt").write_text("1000000001\n")
    (d / "soccer_events.txt").write_text("9999999999\n")
    (d / "indignados_events.txt").write_text("1000000003,8888888888\n")
    return str(d)


@pytest.mark.parametrize("use_native", ["0", "1"])
def test_load_sed2012_dataset_matches_jax(dataset_dir, use_native, monkeypatch):
    """Labels (is_event, event_type), the sentinel date, cleaned text; the
    bounded and skipped parses are the head and tail of the whole one."""
    monkeypatch.setenv("MUSED_TPU_NO_NATIVE_PARSER", "0" if use_native == "1" else "1")
    want = jsed.load_sed2012_dataset(dataset_dir)
    got = tsed.load_sed2012_dataset(dataset_dir)
    assert_table_equals_frame(got, want)
    assert got["is_event"].tolist() == [1, 0, 1] and got["event_type"].tolist() == [1, 0, 3]
    head = tsed.load_sed2012_dataset(dataset_dir, max_records=2)
    assert_table_equals_frame(head, jsed.load_sed2012_dataset(dataset_dir, max_records=2))
    tail = tsed.load_sed2012_dataset(dataset_dir, skip_records=1)
    assert_table_equals_frame(tail, jsed.load_sed2012_dataset(dataset_dir, skip_records=1))
    assert head["id"].tolist() == got["id"][:2].tolist()
    assert tail["id"].tolist() == got["id"][1:].tolist()


def test_native_opt_out_takes_the_python_path(tmp_path, monkeypatch):
    p = tmp_path / "m.xml"
    p.write_text(XML)
    monkeypatch.setenv("MUSED_TPU_NO_NATIVE_PARSER", "1")
    before = tnative.sed_calls
    assert len(tsed.parse_metadata(str(p), {})["id"]) == 3
    assert tnative.sed_calls == before


def test_native_scan_threads_byte_identical(tmp_path):
    p = tmp_path / "m.xml"
    p.write_text(FIXTURES["fuzz"])
    seq = tnative.parse_sed2012(str(p), clean=True, threads=1)
    for threads in (2, 5):
        par = tnative.parse_sed2012(str(p), clean=True, threads=threads)
        for k in seq:
            if isinstance(seq[k], np.ndarray):
                np.testing.assert_array_equal(par[k], seq[k], err_msg=k)
            else:
                assert par[k] == seq[k], k


TIMESTAMPS = (["2012-0%d-1%d 0%d:2%d:3%d.%d" % (i % 8 + 1, i % 3, i % 9, i % 9, i % 9, i % 10)
               for i in range(300)]
              + ["2012-12-31 23:59:59", "1970-01-01 00:00:00", "2000-02-29 12:00:00.5",
                 "1999-01-01 00:00:00.999999", "2012-1-1 1:2:3", "3000-01-01 00:00:00"])


@pytest.mark.parametrize("path", ["vectorized", "per_row"])
def test_convert_timestamp_column_matches_jax(path, monkeypatch):
    """Both of the port's paths (numpy datetime64 under UTC, per-row mktime
    elsewhere) give the JAX package's values; unparseable entries raise."""
    want = jsed.convert_timestamp_column(TIMESTAMPS)
    if path == "per_row":
        monkeypatch.setattr(time, "daylight", 1)
    got = tsed.convert_timestamp_column(TIMESTAMPS)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [tsed.convert_to_timestamp(v) for v in TIMESTAMPS])
    for bad in (["2012-01-01 00:00:00", "garbage"], ["2012-01-01 00:00:00.1234567"],
                ["2012-02-30 00:00:00"]):
        with pytest.raises(ValueError):
            tsed.convert_timestamp_column(bad)


def test_clean_text_and_ground_truth_match_jax():
    for text in ("  <b>Hello</b>, World!! ", "Ünïcode — ok\n\ttabs", "", "a<x>b</x>c"):
        assert tsed.clean_text(text) == jsed.clean_text(text)
    lines = ["1, 2,3\n", "\n", " 4 \n", "5,,6"]
    jgt, tgt = {}, {}
    assert tsed.parse_ground_truth(lines, tgt, 3) == jsed.parse_ground_truth(lines, jgt, 3)
    assert tgt == jgt


def test_synthetic_stream_matches_jax():
    np.testing.assert_array_equal(tsyn.synthetic_stream(n=500, m=4, d=30, zeta=5, seed=2),
                                  jsyn.synthetic_stream(n=500, m=4, d=30, zeta=5, seed=2))
    got, want = tsyn.load_synthetic_dataset(300, d=40, seed=1), \
        jsyn.load_synthetic_dataset(300, d=40, seed=1)
    assert len(got) == 1 and got[0].dtype == np.float64
    np.testing.assert_array_equal(got[0], want[0])
