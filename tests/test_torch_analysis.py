"""The port's analysis rules, baseline, lint CLI and lockset monitor
against the JAX package's, on the CPU.

Findings are compared as (line, code) lists on the fixture corpus of
``tests/analysis_fixtures`` (each fixture with its rule; OBS01 with a
custom hot surface); the torch flavours of DET01 and the port's TRC01
(a kernel library built or loaded per call) fire on sources written to
``tmp_path`` and spare their decoys.  Baseline splits and CLI exit codes
must equal the reference's exactly, and the lockset monitors, driven
through the same scripted interleavings (events fix the order), must
report the same races and states.  The last gate: the port's library
code is lint-clean against its checked-in baseline."""
import json
import threading
from pathlib import Path

import pytest

from repro.analysis import baseline as jbaseline
from repro.analysis import checkers as jcheckers
from repro.analysis import lint as jlint
from repro.analysis import races as jraces
from repro_torch.analysis import baseline as baseline_mod
from repro_torch.analysis import checkers, lint, races
from repro_torch.analysis.checkers import (Dead01UnexercisedBackend,
                                           Det01HiddenSeed,
                                           Trc01PerCallBuild, check_file)

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "analysis_fixtures"
PORT_BASELINE = REPO / "src" / "repro_torch" / "analysis" / "baseline.json"


# -- the fixture corpus, rule by rule ----------------------------------------

def _rule(mod, code):
    if code == "OBS01":
        return mod.Obs01MissingSpan(hot=[("obs01_case.py", ("generate",))])
    return {"DET01": mod.Det01HiddenSeed, "MUT01":
            mod.Mut01SharedMutableDefault,
            "OVF01": mod.Ovf01UnguardedIdShift}[code]()


@pytest.mark.parametrize("name,code", [
    ("det01_case.py", "DET01"), ("mut01_case.py", "MUT01"),
    ("ovf01_case.py", "OVF01"), ("obs01_case.py", "OBS01")])
def test_fixture_findings_equal_the_reference(name, code):
    path = FIXTURES / name
    want = [(v.line, v.code) for v in jcheckers.check_file(
        path, name, [_rule(jcheckers, code)])]
    got = [(v.line, v.code) for v in check_file(
        path, name, [_rule(checkers, code)])]
    assert want and got == want
    tagged = [i for i, ln in enumerate(path.read_text().splitlines(), 1)
              if f"# {code}" in ln]
    assert sorted(line for line, _ in got) == tagged


# -- DET01: torch's hidden global generator ----------------------------------

@pytest.mark.parametrize("line,fires", [
    ("torch.manual_seed(0)", True),
    ("torch.manual_seed(seed)", True),
    ("torch.cuda.manual_seed(1)", True),
    ("torch.cuda.manual_seed_all(seed)", True),
    ("torch.Generator().manual_seed(7)", True),
    ("torch.Generator(device='cuda').manual_seed(7)", True),
    ("gen.manual_seed(3)", True),
    ("torch.rand(3)", True),
    ("torch.randn(3, 4, device=dev)", True),
    ("torch.randint(0, 5, (3,))", True),
    ("torch.randperm(9)", True),
    ("torch.normal(mu, sd)", True),
    ("torch.bernoulli(p)", True),
    ("torch.multinomial(p, 2)", True),
    ("x.uniform_()", True),
    ("x.normal_(0.0, 1.0)", True),
    ("x.exponential_()", True),
    ("x.random_(0, 7)", True),
    ("x.bernoulli_(0.5)", True),
    ("torch.nn.init.normal_(w)", True),
    # decoys
    ("torch.Generator().manual_seed(seed)", False),
    ("gen.manual_seed(seed + shard_id)", False),
    ("torch.randn(3, generator=gen)", False),
    ("torch.randperm(9, generator=gen)", False),
    ("torch.multinomial(p, 2, generator=gen)", False),
    ("x.uniform_(generator=gen)", False),
    ("x.normal_(0.0, 1.0, generator=gen)", False),
    ("rng.normal(size=3)", False),
    ("trandom.normal(key, (3,))", False),
    ("torch.zeros(3)", False),
])
def test_det01_torch_flavours(tmp_path, line, fires):
    path = tmp_path / "mod.py"
    path.write_text("import torch\n\n\ndef f(x, w, p, mu, sd, gen, rng, "
                    "seed, shard_id, dev, key, trandom):\n"
                    f"    return {line}\n")
    got = check_file(path, "mod.py", [Det01HiddenSeed()])
    assert [(v.line, v.code) for v in got] == ([(5, "DET01")] if fires
                                               else [])


# -- TRC01: a kernel library built or loaded per call ------------------------

TRC01_SOURCE = '''\
import ctypes
import functools
import threading

import torch

from repro_torch.kernels import _build

LIB = _build.CudaLibrary(SRC, declare)              # clean: module level
OPS = _build.TorchOpLibrary([SRC], BINDING)         # clean: module level
compiled = torch.compile(step)                      # clean: module level


def per_call_cdll(path):
    return ctypes.CDLL(path)                        # TRC01


def per_call_compile(f, x):
    return torch.compile(f)(x)                      # TRC01


def per_call_load(path):
    torch.ops.load_library(path)                    # TRC01


def per_call_library(src, declare):
    return _build.CudaLibrary(src, declare).lib()   # TRC01


def per_call_nested(path):
    def inner():
        return CudaLibrary(path, None)              # TRC01
    return inner()


@functools.lru_cache(maxsize=None)
def memoized(path):
    return ctypes.CDLL(path)                        # clean: memoized


@functools.cache
def memoized_compile(f):
    return torch.compile(f)                         # clean: memoized


class Holder:
    def __init__(self, path):
        self._lock = threading.Lock()
        self._lib = ctypes.CDLL(path)               # clean: once per object
        self._loaded = False

    def lib(self):
        with self._lock:
            if self._lib is None:
                self._lib = ctypes.CDLL(self.path)  # clean: lock + test
            return self._lib

    def load(self):
        with self._lock:
            if not self._loaded:
                torch.ops.load_library(self.path)   # clean: lock + test
                self._loaded = True

    def test_without_lock(self):
        if self._lib is None:
            self._lib = ctypes.CDLL(self.path)      # TRC01
        return self._lib

    def lock_without_test(self):
        with self._lock:
            return ctypes.CDLL(self.path)           # TRC01
'''


def test_trc01_fires_per_call_and_spares_every_exempt_pattern(tmp_path):
    path = tmp_path / "trc.py"
    path.write_text(TRC01_SOURCE)
    got = check_file(path, "trc.py", [Trc01PerCallBuild()])
    tagged = [i for i, ln in enumerate(TRC01_SOURCE.splitlines(), 1)
              if ln.rstrip().endswith("# TRC01")]
    assert len(tagged) == 7
    assert [(v.line, v.code) for v in got] == [(i, "TRC01") for i in tagged]
    msgs = " ".join(v.message for v in got)
    assert "inside per_call_cdll()" in msgs
    assert "inside per_call_nested()" in msgs


@pytest.mark.parametrize("rel", [
    "src/repro_torch/kernels/_build.py",
    "src/repro_torch/kernels/rmat_sample.py",
    "src/repro_torch/kernels/flash_attention.py",
    "src/repro_torch/kernels/spike.py"])
def test_trc01_spares_the_ports_own_libraries(rel):
    """Module-level libraries and ``_build``'s lock-and-test loads; the
    rule does see the loads there."""
    path = REPO / rel
    assert check_file(path, rel, [Trc01PerCallBuild()]) == []
    text = path.read_text()
    assert any(s in text for s in ("CudaLibrary(", "TorchOpLibrary(",
                                   "ctypes.CDLL(", "load_library("))


# -- DEAD01 ------------------------------------------------------------------

def test_dead01_flags_untested_backend_and_accepts_quoted_name(tmp_path):
    reg = tmp_path / "src" / "core" / "sampler.py"
    reg.parent.mkdir(parents=True)
    reg.write_text(
        "class EdgeSamplerBackend:\n    name = '?'\n\n"
        "class ABackend(EdgeSamplerBackend):\n    name = 'alpha'\n\n"
        "class BBackend(EdgeSamplerBackend):\n    name = 'beta'\n")
    tests = tmp_path / "tests"
    tests.mkdir()
    tests.joinpath("test_smoke.py").write_text(
        "def test_alpha():\n    assert 'alpha'\n")
    kw = dict(registry_rel="src/core/sampler.py", tests_rel="tests")
    got = Dead01UnexercisedBackend(**kw).check_repo(tmp_path)
    want = jcheckers.Dead01UnexercisedBackend(**kw).check_repo(tmp_path)
    assert [(v.file, v.line, v.code) for v in got] == \
        [(v.file, v.line, v.code) for v in want] == \
        [("src/core/sampler.py", 8, "DEAD01")]
    assert "'beta'" in got[0].message and "alpha" not in got[0].message


def test_dead01_reads_the_ports_registry():
    dead = Dead01UnexercisedBackend()
    assert dead.registry_rel == "src/repro_torch/core/sampler.py"
    import ast
    tree = ast.parse((REPO / dead.registry_rel).read_text())
    assert [n for n, _ in dead._backend_names(tree)] == \
        ["reference", "cuda_bits", "cuda_prng"]
    assert dead.check_repo(REPO) == []


# -- baseline ----------------------------------------------------------------

def _split(mod, vclass, base_path, found):
    base = mod.load(base_path)
    new, suppressed, stale = mod.apply(
        [vclass(*v) for v in found], base)
    return ([(v.file, v.line, v.code, v.message) for v in new],
            [(v.file, v.line, v.code, v.message) for v in suppressed],
            stale)


def test_baseline_cycle_equals_the_reference_and_files_cross_load(tmp_path):
    v1 = ("a.py", 3, "DET01", "msg one")
    v2 = ("b.py", 9, "MUT01", "msg two")
    v3 = ("c.py", 1, "OVF01", "msg three")
    rounds = [([v1, v2], [("a.py", 30, "DET01", "msg one"), v2]),
              ([v1, v2], [v1, v3]),
              ([v1, v1], [v1, v1, v1])]
    for frozen, found in rounds:
        port_file, ref_file = tmp_path / "port.json", tmp_path / "ref.json"
        baseline_mod.save(port_file, [checkers.Violation(*v)
                                      for v in frozen])
        jbaseline.save(ref_file, [jcheckers.Violation(*v) for v in frozen])
        want = _split(jbaseline, jcheckers.Violation, ref_file, found)
        assert _split(baseline_mod, checkers.Violation, port_file,
                      found) == want
        # each package loads the other's file
        assert baseline_mod.load(ref_file) == jbaseline.load(ref_file) \
            == jbaseline.load(port_file) == baseline_mod.load(port_file)
        assert json.loads(port_file.read_text())["version"] == 1


def test_baseline_rejects_an_unknown_version(tmp_path):
    path = tmp_path / "b.json"
    path.write_text(json.dumps({"version": 2, "suppressions": []}))
    with pytest.raises(ValueError, match="version"):
        baseline_mod.load(path)


# -- the CLI -----------------------------------------------------------------

def _cli_codes(main, root: Path, capsys) -> list:
    """Exit codes (and summary lines) of one fixed sequence of lint
    calls over a fresh tree under ``root``."""
    target = root / "pkg"
    target.mkdir(parents=True)
    target.joinpath("mod.py").write_text(
        "import numpy as np\n\n"
        "def f():\n    return np.random.default_rng(7)\n")
    base = [str(target), "--root", str(root), "--baseline", "bl.json"]
    seq = [base, base + ["--write-baseline"], base,
           [str(target), "--root", str(root), "--write-baseline"],
           base + ["--rules", "MUT01"], base + ["--rules", "nope01"],
           ["--list-rules"],
           [str(target), "--root", str(root), "--rules", "det01",
            "--markdown-out", str(root / "report.md")]]
    out = []
    for args in seq:
        code = main(args)
        lines = capsys.readouterr().out.splitlines()
        out.append((code, lines[-1].split(":")[0] if lines else ""))
    target.joinpath("mod.py").write_text("def f(rng):\n    return rng\n")
    code = main(base)
    text = capsys.readouterr().out
    out.append((code, "stale baseline entry" in text))
    report = (root / "report.md").read_text()
    out.append(report.splitlines()[2:])
    return out


def test_lint_cli_exit_codes_equal_the_reference(tmp_path, capsys):
    want = _cli_codes(jlint.main, tmp_path / "ref", capsys)
    got = _cli_codes(lint.main, tmp_path / "port", capsys)
    assert got == want
    assert [c for c, _ in got[:8]] == [1, 0, 0, 2, 0, 2, 0, 1]


def test_default_scope_leaves_out_benchmarks_examples_scripts(tmp_path):
    bad = "import numpy as np\n\ndef f():\n    return np.random.seed(0)\n"
    pkg = tmp_path / "src" / "repro_torch"
    for sub in ("core", "benchmarks", "examples", "scripts", "launch"):
        (pkg / sub).mkdir(parents=True)
        (pkg / sub / "m.py").write_text(bad)
    got = lint.run_lint(tmp_path)
    assert sorted(v.file for v in got) == [
        "src/repro_torch/core/m.py", "src/repro_torch/launch/m.py"]
    got = lint.run_lint(tmp_path, ["src/repro_torch/benchmarks",
                                   "src/repro_torch/scripts/m.py"])
    assert sorted(v.file for v in got) == [
        "src/repro_torch/benchmarks/m.py", "src/repro_torch/scripts/m.py"]


def test_port_library_code_is_lint_clean_against_its_baseline():
    """The gate (the port has no CI lane): every rule over the default
    scope, against the checked-in baseline, which freezes nothing."""
    violations = lint.run_lint(REPO)
    base = baseline_mod.load(PORT_BASELINE)
    assert sum(base.values()) == 0
    new, _, stale = baseline_mod.apply(violations, base)
    assert new == [], "\n".join(v.render() for v in new)
    assert stale == []
    files = lint.collect_files(REPO, lint.DEFAULT_PATHS)
    rels = {f.relative_to(REPO.resolve()).parts[2] for f in files}
    assert {"analysis", "core", "datastream", "kernels", "launch"} <= rels
    assert not {"benchmarks", "examples", "scripts"} & rels


# -- the lockset monitor, scripted -------------------------------------------

def _stepper(n: int):
    """``turn(i)`` blocks until step ``i`` may run; ``done(i)`` lets step
    ``i + 1`` go.  Steps run in index order across threads."""
    go = [threading.Event() for _ in range(n + 1)]
    go[0].set()

    def turn(i):
        assert go[i].wait(10)

    def done(i):
        go[i + 1].set()
    return turn, done


def _scripted(mod, steps, names, hold):
    """Each step ``(thread, var, write, lock)`` runs on its thread in
    order.  With ``hold`` every thread stays alive until all steps ran;
    without, the threads run one after another (each thread's steps
    contiguous), each joined before the next starts."""
    mon = mod.RaceMonitor()
    locks = {}
    turn, done = _stepper(len(steps))
    finish = threading.Event()

    def worker(k):
        def body():
            for i, (t, var, write, lock) in enumerate(steps):
                if t != k:
                    continue
                turn(i)
                if lock is None:
                    mon.record(var, write=write)
                else:
                    with locks[lock]:
                        mon.record(var, write=write)
                done(i)
            if hold:
                assert finish.wait(10)
        return body

    for _, _, _, lock in steps:
        if lock is not None and lock not in locks:
            locks[lock] = mon.wrap_lock(threading.Lock(), lock)
    ts = [threading.Thread(target=worker(k), name=n)
          for k, n in enumerate(names)]
    for t in ts:
        t.start()
        if not hold:
            t.join(10)
    turn(len(steps))
    finish.set()
    for t in ts:
        t.join(10)
        assert not t.is_alive()
    return mon


SCENARIOS = {
    # A writes, B writes unlocked, A writes again: both live → one race
    "unlocked-write-race": ([(0, "v", True, None), (1, "v", True, None),
                             (0, "v", True, None)], True),
    # every access under L: shared-modified, no race
    "consistent-locking": ([(k % 3, "v", True, "L") for k in range(30)],
                           True),
    # two locks, never the same one: the lockset empties → race
    "disjoint-locks": ([(0, "v", True, "L1"), (1, "v", True, "L2"),
                        (0, "v", True, "L1")], True),
    # read-shared by three threads after the first write: never a race
    "read-sharing": ([(0, "v", True, None)]
                     + [(1 + k % 3, "v", False, None) for k in range(12)],
                     True),
    # reads under L, then a locked write: shared-read → shared-modified
    "read-then-locked-write": ([(0, "v", True, "L"), (1, "v", False, "L"),
                                (0, "v", True, "L"), (1, "v", True, "L")],
                               True),
    # hand-offs between threads that have exited (join happens-before)
    "dead-thread-transfer": ([(0, "v", True, None), (1, "v", True, None),
                              (2, "v", False, None)], False),
    # two variables, one raced, one protected
    "two-variables": ([(0, "a", True, None), (0, "b", True, "L"),
                       (1, "a", True, None), (1, "b", True, "L"),
                       (0, "a", False, None), (0, "b", False, "L")], True),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_lockset_scenarios_agree_with_the_reference(name):
    steps, hold = SCENARIOS[name]
    names = [f"racer-{k}" for k in range(1 + max(s[0] for s in steps))]
    result = []
    for mod in (jraces, races):
        mon = _scripted(mod, steps, names, hold)
        result.append((
            [(r.var, r.threads, r.write) for r in mon.races()],
            {v: mon.state_of(v) for v in ("v", "a", "b", "w")},
            mon.n_accesses))
    assert result[1] == result[0]
    raced = {"unlocked-write-race": ["v"], "disjoint-locks": ["v"],
             "two-variables": ["a"]}.get(name, [])
    assert [r[0] for r in result[1][0]] == raced


def test_monitored_dict_and_watch_attrs_agree_with_the_reference():
    result = []
    for mod in (jraces, races):
        mon = mod.RaceMonitor()
        d = mod.MonitoredDict(mon, "D", {"a": 1})
        d["b"] = 2
        assert d.get("a") == 1 and "b" in d
        d.pop("b")
        list(d.items())

        class Obj:
            pass

        o = Obj()
        o.x = 0
        mod.watch_attrs(mon, o, ("x",), "Obj")
        o.x += 1
        assert o.x == 1 and isinstance(o, Obj)
        result.append((mon.n_accesses, mon.state_of("D"),
                       mon.state_of("Obj.x"), mon.races()))
    assert result[0] == result[1]
    assert result[1][:3] == (8, "exclusive", "exclusive")


def test_hook_init_runs_after_construction_and_restores():
    class C:
        def __init__(self, v):
            self.v = v

    orig = C.__init__
    seen = []
    with races.hook_init(C, lambda obj: seen.append(obj.v)):
        C(3)
    C(4)
    assert seen == [3] and C.__init__ is orig
