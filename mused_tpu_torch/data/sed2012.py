"""SED2012 dataset ingest without pandas — port of ``mused_tpu/data/sed2012.py``
(reference data_loader.py:9-188).

The loader returns the port's column table: a dict of numpy columns, the
layout of ``data/synthetic.synthetic_events`` plus ``id``:

  id          (n,) int64              datetaken, dateupload (n,) float64
  latitude, longitude (n,) float64    title, description, username (n,) object str
  tags        list of n lists of str  event_id, is_event, event_type (n,) int64

(:func:`parse_metadata` returns the first ten of these, its timestamps
still the raw strings.)  Text is cleaned with the reference's regex
pipeline; timestamps are converted like the reference (local-time
``mktime``, fractional seconds dropped, the ``0000-00-00 ...`` sentinel
replaced by the epoch).  The XML is read by the native C++ scanner
(``native/sed2012_parser.cpp``) when it builds, else streamed with
``xml.etree.ElementTree.iterparse``; both give the same table.

:func:`prepare_modalities` orders sampled rows exactly as the JAX package's
``df.sort_values(by="dateupload")`` does: pandas sorts the non-NaN values
with numpy's (unstable) quicksort argsort and appends the NaN rows in their
original order, so rows with tied upload times keep the JAX package's order.
"""
from __future__ import annotations

import datetime
import os
import re
import time
import xml.etree.ElementTree as ET

import numpy as np

DATASET_DIR = "dataset/sed2012"
MODALITY_TYPES = ["location", "time", "username", "tags", "text"]
EPOCH = "1970-01-01 00:00:00"
ZERO_DATE = "0000-00-00 00:00:00"

_HTML_RE = re.compile(r"<.*?>")
_PUNCT_RE = re.compile(r"[^a-zA-Z0-9\s]")
_WS_RE = re.compile(r"\s+")
# the zero-padded "%Y-%m-%d %H:%M:%S[.%f]" form numpy's datetime64 parses
_PADDED_RE = re.compile(r"^\d{4}-\d\d-\d\d \d\d:\d\d:\d\d(\.\d{1,6})?$")


def clean_text(text: str) -> str:
    """Reference text normalization (data_loader.py:180-185)."""
    text = text.strip()
    text = _HTML_RE.sub(" ", text)
    text = _PUNCT_RE.sub(" ", text)
    text = _WS_RE.sub(" ", text)
    return text.strip().lower()


def convert_to_timestamp(x: str) -> float:
    """Reference timestamp conversion (data_loader.py:187-188), accepting
    the sentinel's form without fractional seconds too."""
    for fmt in ("%Y-%m-%d %H:%M:%S.%f", "%Y-%m-%d %H:%M:%S"):
        try:
            return time.mktime(datetime.datetime.strptime(x, fmt).timetuple())
        except ValueError:
            continue
    raise ValueError(f"unparseable timestamp: {x!r}")


def convert_timestamp_column(values) -> np.ndarray:
    """:func:`convert_to_timestamp` over a whole column (float64).

    ``mktime`` reads the fields in the host's local time zone and
    ``timetuple()`` drops the fraction.  Under UTC (``time.timezone == 0``
    and no DST rule) that is the seconds since the epoch of the wall-clock
    fields, so zero-padded entries convert at once through numpy
    ``datetime64``; any other entry (unpadded fields, a bad date) takes the
    per-row conversion, which converts it or raises as the reference does.
    On a non-UTC host every row takes the per-row conversion."""
    values = list(values)
    if time.timezone != 0 or time.daylight:
        return np.fromiter((convert_to_timestamp(v) for v in values), np.float64,
                           count=len(values))
    out = np.empty(len(values), np.float64)
    fast = np.array([isinstance(v, str) and _PADDED_RE.match(v) is not None
                     for v in values], bool)
    if fast.any():
        secs = [v[:19].replace(" ", "T") for v, f in zip(values, fast) if f]
        try:
            parsed = np.array(secs, "datetime64[s]")
        except ValueError:              # e.g. day 30 in February: per row
            fast[:] = False
        else:
            out[fast] = (parsed - np.datetime64(0, "s")).astype(np.float64)
    for i in np.flatnonzero(~fast):
        out[i] = convert_to_timestamp(values[i])
    return out


def parse_ground_truth(lines, ground_truth: dict, class_counter: int = 1) -> int:
    """One ground-truth txt: each line lists a comma-separated photo-id group
    forming one event class (reference data_loader.py:115-128).  Returns the
    next unused class id."""
    counter = class_counter
    for line in lines:
        ids = [tok.strip() for tok in line.strip().split(",") if tok.strip()]
        if not ids:
            continue
        for pid in ids:
            ground_truth[pid] = counter
        counter += 1
    return counter


def _object(items) -> np.ndarray:
    out = np.empty(len(items), object)
    out[:] = items
    return out


def _table(ids, taken, uploaded, lat, lon, title, desc, tags, user, event_id) -> dict:
    return {"id": np.array([int(p) for p in ids], np.int64),
            "datetaken": _object(taken), "dateupload": _object(uploaded),
            "latitude": np.asarray(lat, np.float64), "longitude": np.asarray(lon, np.float64),
            "title": _object(title), "description": _object(desc), "tags": list(tags),
            "username": _object(user), "event_id": np.asarray(event_id, np.int64)}


def load_sed2012_dataset(dataset_dir: str = DATASET_DIR, max_records: int | None = None,
                         skip_records: int = 0) -> dict:
    """The reference loader (data_loader.py:9-50): three ground-truth files
    -> photo id to event id; the metadata XML; derived ``is_event`` /
    ``event_type`` labels; timestamp conversion.  ``max_records`` /
    ``skip_records`` bound and offset the XML parse."""
    ground_truth: dict[str, int] = {}
    ranges = {}
    lo = 1
    for name, fname in (("technical", "technical_events.txt"),
                        ("soccer", "soccer_events.txt"),
                        ("indignados", "indignados_events.txt")):
        with open(os.path.join(dataset_dir, fname)) as f:
            nxt = parse_ground_truth(f.readlines(), ground_truth, class_counter=lo)
        ranges[name] = (lo, nxt - 1)
        lo = nxt

    table = parse_metadata(os.path.join(dataset_dir, "sed2012_metadata.xml"), ground_truth,
                           max_records=max_records, skip_records=skip_records)
    min_tech, max_tech = ranges["technical"]
    min_soc, max_soc = ranges["soccer"]
    min_ind, max_ind = ranges["indignados"]
    eid = table["event_id"]
    table["is_event"] = np.where((eid >= min_tech) & (eid <= max_ind), 1, 0)
    table["event_type"] = np.select(
        [(eid >= min_tech) & (eid <= max_tech),
         (eid >= min_soc) & (eid <= max_soc),
         (eid >= min_ind) & (eid <= max_ind)],
        [1, 2, 3], default=0)
    for col in ("datetaken", "dateupload"):
        table[col] = convert_timestamp_column(
            [EPOCH if v == ZERO_DATE else v for v in table[col]])
    return table


def parse_metadata(metadata_path: str, ground_truth: dict, max_records: int | None = None,
                   skip_records: int = 0, use_native: bool | None = None) -> dict:
    """The reference's get_modalities (data_loader.py:130-178) -> the column
    table without labels, timestamps as strings.  ``skip_records`` photos
    are skipped and at most ``max_records`` parsed.  ``use_native``: the C++
    scanner (None = when it builds, unless MUSED_TPU_NO_NATIVE_PARSER=1),
    else the Python iterparse stream, which holds one record at a time."""
    if use_native is None:
        use_native = os.environ.get("MUSED_TPU_NO_NATIVE_PARSER", "") != "1"
    if use_native:
        from mused_tpu_torch import native
        cols = native.parse_sed2012(metadata_path, skip_records=skip_records,
                                    max_records=max_records, clean=True)
        if cols is not None:
            ends = np.cumsum(cols["tag_counts"], dtype=np.int64)
            tags = [cols["tags"][e - c:e] for e, c in zip(ends.tolist(),
                                                           cols["tag_counts"].tolist())]
            lat, lon = cols["lat"], cols["lon"]
            # one try covers both floats in the reference (data_loader
            # :144-149): an unparseable latitude voids the longitude too
            return _table(cols["id"], [s.strip() for s in cols["taken"]],
                          [s.strip() for s in cols["uploaded"]],
                          np.where(np.isnan(lon), np.nan, lat),
                          np.where(np.isnan(lat), np.nan, lon),
                          cols["title"], cols["description"], tags,
                          [s.strip() for s in cols["username"]],
                          [ground_truth.get(p, 0) for p in cols["id"]])
    rows = []
    root = None
    seen = 0
    for event, elem in ET.iterparse(metadata_path, events=("start", "end")):
        if event == "start":
            if root is None:
                root = elem
            continue
        if elem.tag != "photo":
            continue
        seen += 1
        if seen <= skip_records:
            elem.clear()
            root.clear()
            continue
        if max_records is not None and len(rows) >= max_records:
            break
        pid = elem.get("id", "")
        loc = elem.find("location")
        try:
            latitude = float(loc.get("latitude"))
            longitude = float(loc.get("longitude"))
        except (AttributeError, TypeError, ValueError):
            latitude, longitude = np.nan, np.nan
        title_el, desc_el = elem.find("title"), elem.find("description")
        rows.append((pid, (elem.get("dateTaken") or "").strip(),
                     (elem.get("dateUploaded") or "").strip(), latitude, longitude,
                     clean_text(title_el.text) if title_el is not None and title_el.text
                     else "",
                     clean_text(desc_el.text) if desc_el is not None and desc_el.text
                     else "",
                     [clean_text(t.text) for t in elem.findall(".//tag")
                      if t.text is not None],
                     (elem.get("username") or "").strip(), ground_truth.get(pid, 0)))
        elem.clear()
        root.clear()        # drop processed children: memory stays one record
    return _table(*(list(c) for c in zip(*rows))) if rows else _table(*([[]] * 10))


def upload_order(dateupload: np.ndarray) -> np.ndarray:
    """The row order of pandas' ``sort_values`` on a float column: numpy's
    quicksort argsort of the non-NaN values, then the NaN rows in their
    original order."""
    values = np.asarray(dateupload)
    nan = np.isnan(values)
    idx = np.arange(len(values))
    return np.concatenate([idx[~nan][values[~nan].argsort(kind="quicksort")], idx[nan]])


def _object_column(cells: list) -> np.ndarray:
    """(n, 1) object array holding one Python object (e.g. a list) per row."""
    col = np.empty((len(cells), 1), object)
    for i, c in enumerate(cells):
        col[i, 0] = c
    return col


def prepare_modalities(df: dict, subset_size: int = 10000, sort_by_uploaded: bool = True,
                       event_types: bool = False, binary: bool = False,
                       noise_rate: float = 0.95, seed: int = 0):
    """Label-mode selection + seeded noise / event subsampling + modality
    split of a column table (reference data_loader.py:52-113, the JAX
    package's sampling arithmetic and RNG stream) -> (modalities,
    modality_types, labels), the layout of the JAX package's DataFrame
    version:

      location (n, 2) float64 [lat, lon]     time (n, 2) float64 [taken, upload]
      username (n, 1) object str             tags (n, 1) object list[str]
      text     (n, 2) object [title, desc]   labels (n,) int64
    """
    labels = df["is_event" if binary else "event_type" if event_types else "event_id"]
    subset_size = min(subset_size, len(labels))
    rng = np.random.default_rng(seed=seed)
    rows = np.arange(len(labels))
    if 0 <= noise_rate < 1.0:
        noise_idx = np.where(labels == 0)[0]
        event_idx = np.where(labels > 0)[0]
        num_events = min(int((1 - noise_rate) * subset_size), len(event_idx))
        sampled_noise = rng.choice(noise_idx, subset_size - num_events, replace=False)
        sampled_events = rng.choice(event_idx, num_events, replace=False)
        rows = np.sort(np.concatenate([sampled_noise, sampled_events]))
    if sort_by_uploaded:
        rows = rows[upload_order(df["dateupload"][rows])]

    def pair(a, b):
        return np.stack([df[a][rows], df[b][rows]], axis=1)

    modalities = [pair("latitude", "longitude"), pair("datetaken", "dateupload"),
                  np.asarray(df["username"])[rows][:, None],
                  _object_column([df["tags"][r] for r in rows]),
                  pair("title", "description")]
    return modalities, list(MODALITY_TYPES), labels[rows]
