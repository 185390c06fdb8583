"""The static analyzer still sees the JAX package beside the port.

``tools/analyze`` resolves classes by bare name across ``src/``: a port
class named like a reference class makes the name ambiguous, and then the
reference's lock edges and contracts silently drop out of the gate (the
port's spec class was once named ``DataSpec``, which switched the
dataspec-classification contract off).  These tests hold every name the
gate depends on to one class, and hold the port's spec, which that contract
does not cover, to the reference's classification."""
import ast
import dataclasses
import os

import pytest

from repro.pipeline import spec as ref_spec
from repro_torch.pipeline import spec as port_spec
from tools.analyze.contracts import check_adapters, check_dataspec, check_iostats
from tools.analyze.model import build_model
from tools.analyze.runtime import static_lock_graph

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


@pytest.fixture(scope="module")
def model():
    return build_model(SRC)


def _in_reference(path: str) -> bool:
    return os.sep + os.path.join("src", "repro") + os.sep in os.sep + os.path.normpath(path)


def _opener_classes(model) -> set[str]:
    """Class names the reference's ``@register_backend`` openers return."""
    names = set()
    for mod in model.modules.values():
        if not _in_reference(mod.file):
            continue
        for stmt in mod.tree.body:
            if isinstance(stmt, ast.FunctionDef) and any(
                isinstance(d, ast.Call) and getattr(d.func, "id", "") == "register_backend"
                for d in stmt.decorator_list
            ):
                names.add(ast.unparse(stmt.returns).strip("'\"").split(".")[-1])
    return names


def _gate_names(model) -> set[str]:
    lock_bearing = {c.name for c in model.classes() if c.locks and _in_reference(c.file)}
    openers = _opener_classes(model)
    bases = set()
    for name in openers:
        for c in model.classes():
            if c.name == name and _in_reference(c.file):
                bases |= {b.name for b in model.mro(c)}
    assert len(lock_bearing) > 10 and {"PlannedCollection", "IOStats", "BlockCache"} <= lock_bearing
    assert {"CSRAdapter", "ShardedCSRAdapter", "ChunkedAdapter", "TokenAdapter"} <= openers
    assert "StorageAdapter" in bases
    return lock_bearing | openers | bases | {"IOStats", "PendingIO", "DataSpec"}


def test_every_gate_name_resolves_to_the_reference_class(model):
    for name in sorted(_gate_names(model)):
        cls = model.resolve_class(name)
        assert cls is not None, f"{name!r} is ambiguous or unknown over src/"
        assert _in_reference(cls.file), (name, cls.file)


def test_contracts_check_the_reference_classes(model):
    spec = model.resolve_class("DataSpec")
    assert spec is not None and spec.file.endswith(os.path.join("repro", "pipeline", "spec.py"))
    assert check_dataspec(model) == []
    assert check_iostats(model) == []
    assert check_adapters(model) == []


def test_the_port_adds_no_lock_edge():
    """The port's planner nests no lock of one module inside another's."""
    graph = static_lock_graph(SRC)
    port_ids = [i for i in graph.kinds if i.startswith("repro_torch.")]
    assert "repro_torch.data.backend.PlannedRows._fl" in port_ids
    assert "repro_torch.data.iostats.IOCounters._lock" in port_ids
    assert not [e for e in graph.edges if e[0].startswith("repro_torch.") or e[1].startswith("repro_torch.")]


def test_port_spec_classification_equals_the_reference():
    ours = [(f.name, f.type, f.default) for f in dataclasses.fields(port_spec.PipelineSpec)]
    theirs = [(f.name, f.type, f.default) for f in dataclasses.fields(ref_spec.DataSpec)]
    assert ours == theirs
    assert port_spec.FINGERPRINT_FIELDS == ref_spec.FINGERPRINT_FIELDS
    assert port_spec.CONTENT_FREE_FIELDS == ref_spec.CONTENT_FREE_FIELDS
    names = {f.name for f in dataclasses.fields(port_spec.PipelineSpec)}
    assert port_spec.FINGERPRINT_FIELDS | port_spec.CONTENT_FREE_FIELDS == names
    assert not port_spec.FINGERPRINT_FIELDS & port_spec.CONTENT_FREE_FIELDS
    assert port_spec.DataSpec is port_spec.PipelineSpec


#: the reference's lock-bearing classes the port meets, and the port's
#: counterparts, named apart
RENAMED = {"DiversityMonitor": "EntropyMonitor", "CloudAdapter": "CloudReader",
           "FaultInjectingAdapter": "FaultInjectingReader", "ShardBreaker": "ShardCircuit",
           "HeartbeatMonitor": "LivenessMonitor", "DataServeServer": "BatchServer",
           "CollectionPool": "SharedCollections", "ElasticSupervisor": "RankSupervisor"}


def test_the_resilience_and_diversity_classes_are_named_apart(model):
    """Each reference class resolves to the reference; each port class to
    the port, with its lock in the static graph and no edge through it."""
    graph = static_lock_graph(SRC)
    for ref_name, port_name in RENAMED.items():
        ref_cls, port_cls = model.resolve_class(ref_name), model.resolve_class(port_name)
        assert ref_cls is not None and _in_reference(ref_cls.file), ref_name
        assert ref_cls.locks, ref_name
        assert port_cls is not None and not _in_reference(port_cls.file), port_name
        assert port_cls.locks, port_name
        ids = {port_cls.lock_id(a) for a in port_cls.locks}
        assert ids <= set(graph.kinds)
        assert not [e for e in graph.edges if e[0] in ids or e[1] in ids], port_name

