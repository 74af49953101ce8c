"""Running the port's serving examples in-process and reading their lines.

Each ``examples/torch_*.py`` has ``main(argv)``; :func:`run` loads the file
as a module, calls ``main(["--device", "cpu", ...])`` under ``capsys`` and
returns the printed lines.  :func:`match` holds those lines, in order, to
regular expressions written from the original example's ``print`` calls,
and :func:`printed_close` holds a printed number to a value computed by
the reference's own functions, at the printed precision.
"""

import importlib.util
import pathlib
import re

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent


def load(name: str):
    """``examples/torch_<name>.py`` as a module (not run as __main__)."""
    path = ROOT / "examples" / f"torch_{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reference(name: str):
    """The reference's ``examples/<name>.py`` as a module (its helpers,
    such as ``make_sysp``, are the reference's own functions)."""
    path = ROOT / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"ref_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run(mod, capsys, *args):
    """``mod.main(["--device", "cpu", *args])`` at one intra-op thread (the
    suite runs several test processes side by side); its non-blank
    printed lines.  ``main`` must return cleanly (its in-script
    assertions included)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        capsys.readouterr()
        assert mod.main(["--device", "cpu", *args]) is None
    finally:
        torch.set_num_threads(n)
    return [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]


def match(lines, spec):
    """Match ``lines`` in order against ``spec``: (regex, count) pairs,
    count an int or ``"+"`` (one or more) or ``"*"`` (any number).  Every
    line must be consumed.  Returns the match objects per spec entry."""
    out, i = [], 0
    for regex, count in spec:
        pat = re.compile(regex)
        got = []
        while i < len(lines) and (count in ("+", "*") or len(got) < count):
            m = pat.fullmatch(lines[i])
            if m is None:
                break
            got.append(m)
            i += 1
        want = f"{count}" if isinstance(count, int) else count
        assert (len(got) == count if isinstance(count, int)
                else len(got) >= (1 if count == "+" else 0)), \
            (f"expected {want} line(s) matching {regex!r} at line {i}: "
             f"{lines[i] if i < len(lines) else '<end>'!r}")
        out.append(got)
    assert i == len(lines), f"unmatched lines from {i}: {lines[i:]}"
    return out


def printed_close(text: str, value: float) -> bool:
    """``text`` (as printed: fixed or exponent notation) is ``value``
    rounded at the printed precision: within half a unit of its last
    digit, plus 1e-6 relative: the port's float32 value and the
    reference's may differ in their last bits."""
    s = text.strip()
    mant, _, exp = s.lower().partition("e")
    decimals = len(mant.split(".")[1]) if "." in mant else 0
    unit = 10.0 ** (-decimals) * (10.0 ** int(exp) if exp else 1.0)
    return abs(float(s) - value) <= 0.5 * unit * (1 + 1e-9) \
        + 1e-6 * abs(value)
