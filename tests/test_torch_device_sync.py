"""tests/test_device_sync.py on the port: the device-sync guards of the
snapshot encoder (ops/encoding.py) and the template cache's fingerprint
memo (ops/templates.py), each case run on the reference's encoder and on
the port's (device="cpu") from the same nodes and pods, the outcomes
compared:

  * capacity growth re-uploads only the reshaped fields: an untouched
    field keeps its device array (in the port, the same tensor object),
    and the device snapshot equals the host masters (reference :40);
  * invalidate_device() forces a fresh upload of every field (:58);
  * the fingerprint memo drops its entries when the vocabulary grows: a
    service predicate that matches the pods reaches their template rows
    (:95).

The reference's other two cases have no counterpart: the two-pad
chunked dirty-row scatter (:68) and warm_scatter_programs (:82) exist to
bound XLA's compiled scatter shapes; the port's flush scatters with
index_copy_ at any row count and compiles nothing."""

import importlib

import numpy as np

PKGS = ("kubernetes_tpu", "kubernetes_tpu_torch")
FIELDS = ("requested", "sel_counts", "port_counts", "eterm_w", "allocatable")


class _Pkg:
    def __init__(self, pkg):
        self.pkg = pkg
        mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
        self.v1 = mod("api.objects")
        self.LabelSelector = mod("api.selectors").LabelSelector
        self.make_node_object = mod("kubelet.kubelet").make_node_object
        enc = mod("ops.encoding")
        self.EncodingConfig, self.SnapshotEncoder = enc.EncodingConfig, enc.SnapshotEncoder
        self.TemplateCache = mod("ops.templates").TemplateCache

    def enc(self, n_nodes=8, **overrides):
        kw = {"device": "cpu"} if self.pkg == "kubernetes_tpu_torch" else {}
        enc = self.SnapshotEncoder(self.EncodingConfig(**overrides), **kw)
        for i in range(n_nodes):
            enc.add_node(self.make_node_object(f"n{i}", cpu="8"))
        return enc

    def pod(self, name, cpu="100m", labels=None):
        v1 = self.v1
        return v1.Pod(
            metadata=v1.ObjectMeta(name=name, labels=labels or {}),
            spec=v1.PodSpec(containers=[v1.Container(requests={"cpu": cpu})]),
        )


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def _device_fields(enc) -> dict:
    """The flushed device snapshot's fields, after checking that they
    equal the host masters."""
    dev, m = enc.flush(), enc._masters()
    out = {}
    for f in FIELDS:
        a, b = _np(getattr(dev, f)), _np(getattr(m, f))
        assert np.array_equal(a, b), f
        out[f] = a
    return out


def _both(scenario):
    ref, port = (scenario(_Pkg(pkg)) for pkg in PKGS)
    fields_ref, fields_port = ref.pop("fields"), port.pop("fields")
    assert port == ref, (ref, port)
    for f in FIELDS:
        assert fields_ref[f].shape == fields_port[f].shape, f
        assert np.array_equal(fields_ref[f], fields_port[f]), f
    return port


def test_reshape_upload_keeps_unchanged_device_fields():
    """Growing only the eterm capacity reshapes eterm_w; `requested` (no
    dirty rows) keeps its device array, and the snapshot still equals
    the masters."""

    def scenario(p):
        enc = p.enc()
        enc.add_pod("n0", p.pod("a"))
        req0 = enc.flush().requested
        t_cap0 = enc.cfg.t_cap
        enc._ensure_cap("t_cap", t_cap0 * 2)
        flags = (enc._full_upload, enc._content_invalid)
        dev1 = enc.flush()
        return {
            "flags": flags,
            "t_cap": (t_cap0, enc.cfg.t_cap, dev1.eterm_w.shape[1]),
            "kept": dev1.requested is req0,
            "fields": _device_fields(enc),
        }

    got = _both(scenario)
    assert got["flags"] == (True, False)
    t_cap0, t_cap, width = got["t_cap"]
    assert t_cap == 2 * t_cap0 == width
    assert got["kept"]


def test_content_invalid_forces_true_full_upload():
    def scenario(p):
        enc = p.enc()
        enc.add_pod("n0", p.pod("a"))
        dev0 = enc.flush()
        enc.invalidate_device()
        flags = (enc._full_upload, enc._content_invalid)
        dev1 = enc.flush()
        return {
            "flags": flags,
            "fresh": dev1.requested is not dev0.requested,
            "fields": _device_fields(enc),
        }

    got = _both(scenario)
    assert got == {"flags": (True, True), "fresh": True}


def test_fingerprint_memo_invalidates_on_vocab_growth():
    """A memoized pod fingerprint must not survive vocabulary growth: a
    new service predicate that matches the pods changes their label
    effects, the memo's epoch moves, and the template rows carry the
    predicate's match; re-encoding with no vocabulary change reuses the
    memo."""

    def scenario(p):
        enc = p.enc()
        tc = p.TemplateCache(enc)
        pods = [p.pod(f"p{i}", labels={"app": "web"}) for i in range(4)]
        eb1 = tc.encode(pods, pad_to=4)
        epoch1 = tc._fp_epoch
        enc.register_service_predicate(
            "default", p.LabelSelector.make(match_labels={"app": "web"}))
        eb2 = tc.encode(pods, pad_to=4)
        epoch2 = tc._fp_epoch
        sid = enc.service_sid_mask().nonzero()[0]
        match = _np(eb2.tpl_np.match_sel)[:, sid]
        eb3 = tc.encode(pods, pad_to=4)
        return {
            "templates": (eb1.num_templates, eb2.num_templates, eb3.num_templates),
            "epoch_moved": epoch2 > epoch1,
            "epoch_kept": tc._fp_epoch == epoch2,
            "memo_epochs": sorted({ent[1] for ent in tc._fp_memo.values()}) == [epoch2],
            "sid_matched": bool(match.any()),
            "fields": {f: _np(getattr(enc.flush(), f)) for f in FIELDS},
        }

    got = _both(scenario)
    t1, t2, t3 = got["templates"]
    assert t1 >= 1 and t2 >= 1 and t3 == t2
    assert got["epoch_moved"] and got["epoch_kept"] and got["memo_epochs"]
    assert got["sid_matched"]
