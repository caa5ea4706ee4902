"""Tiny shared ``--key=value`` argv parser for the non-config-driven CLI
flags (serve/bench_serve/export; port of human_pose_tpu/utils/argv.py).
The experiment-config override grammar (``--a.b.c=v``) lives in
configs/cli.py; this covers the handful of flat
process-level flags those CLIs take in addition, with one behavior everywhere:

* typed coercion from the default's type (bool accepts bare ``--flag`` and
  ``--flag=true/false/1/0/yes/no``),
* unknown ``--`` tokens either pass through (to the config override parser)
  or abort with the known-flag list — never silently ignored.
"""

from __future__ import annotations

_TRUE = ("1", "true", "yes")
_FALSE = ("0", "false", "no")


def parse_flags(
    argv: list[str], defaults: dict, allow_passthrough: bool = False
) -> tuple[dict, list[str]]:
    """Parse ``argv`` against typed ``defaults``; returns (flags, passthrough).

    Unknown tokens go to ``passthrough`` when ``allow_passthrough`` (CLIs that
    forward config overrides), otherwise raise ``SystemExit`` naming the known
    flags — a typo must not silently run with defaults."""
    flags = dict(defaults)
    rest: list[str] = []
    for tok in argv:
        if tok.startswith("--"):
            k, _, v = tok[2:].partition("=")
            if k in flags:
                cur = flags[k]
                if isinstance(cur, bool):
                    if v == "":
                        flags[k] = True
                    elif v.lower() in _TRUE:
                        flags[k] = True
                    elif v.lower() in _FALSE:
                        flags[k] = False
                    else:
                        raise SystemExit(f"--{k} expects a boolean, got {v!r}")
                elif "=" not in tok:
                    raise SystemExit(f"--{k} requires =value")
                elif cur is None:
                    flags[k] = v
                else:
                    try:
                        flags[k] = type(cur)(v)
                    except ValueError as e:
                        raise SystemExit(f"--{k}: {e}") from None
                continue
        if allow_passthrough:
            rest.append(tok)
        else:
            known = ", ".join(f"--{k}" for k in defaults)
            raise SystemExit(f"unknown flag {tok!r}; known flags: {known}")
    return flags, rest
