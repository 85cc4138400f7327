"""Reading the program's own spans (``rubiksnet_torch.utils.profiling``)
for the per-layer metrics that need them. Each helper returns None, and
does not raise, where the program has no span registry (a checkout from
before it), recorded no matching span, or recorded no device times (the
CPU)."""

from __future__ import annotations

import importlib

REGISTRY = "rubiksnet_torch.utils.profiling"
SETUP_PREFIX = "rubiksnet.setup."


def registry():
    """The program's span registry, or None where it has none."""
    try:
        module = importlib.import_module(REGISTRY)
    except ImportError:
        return None
    return module if hasattr(module, "spans") else None


def device_share(part: str, whole: str, calls: int):
    """Per cent of the device seconds of the spans named ``whole`` that
    the spans named ``part`` took, over the first ``calls`` spans named
    ``whole`` and what they hold: the traced window's calls, traced with
    the device's activity alone. The calls after them run under the
    host's tracer too, which slows a host-bound phase, so they are left
    out."""
    reg = registry()
    if reg is None:
        return None
    records = sorted(reg.spans(), key=lambda r: r.id)
    kept = set([r.id for r in records if r.name == whole][:calls])
    for r in records:
        if r.parent in kept:
            kept.add(r.id)
    seconds = {part: None, whole: None}
    for r in records:
        if r.id in kept and r.name in seconds and (
                r.device_start_s is not None):
            seconds[r.name] = (seconds[r.name] or 0.0) + (
                r.device_end_s - r.device_start_s)
    if seconds[part] is None or not seconds[whole]:
        return None
    return 100.0 * seconds[part] / seconds[whole]


def setup_seconds():
    """Host seconds of the ``rubiksnet.setup.*`` spans, nested ones counted
    once: the length of the union of their intervals."""
    reg = registry()
    if reg is None:
        return None
    spans = sorted((r.start_ns, r.end_ns) for r in reg.spans()
                   if r.name.startswith(SETUP_PREFIX))
    if not spans:
        return None
    total, cur = 0, spans[0][0]
    for a, b in spans:
        a = max(a, cur)
        if b > a:
            total += b - a
            cur = b
    return total * 1e-9
