"""Plugin auto-discovery — the ServiceLoader role.

Counterpart of ``predictionio_tpu/serving/plugins.py``; the entry-point
groups carry the port's package name.

The reference discovers engine-server and event-server plugins from the
classpath via ``java.util.ServiceLoader``
(``core/src/main/scala/org/apache/predictionio/workflow/
EngineServerPluginContext.scala:34-97``): dropping a jar on the classpath
registers its plugins with no flags. The Python-native equivalent is
package entry points: an installed plugin package declares

    [project.entry-points."predictionio_tpu_torch.plugins"]
    my-blocker = my_pkg.plugins:MyBlocker

and it appears in ``/plugins.json`` on the next deploy with no CLI flag.
``PIO_PLUGINS`` (comma-separated dotted paths) covers environments where
installing a distribution isn't possible, and ``--plugin`` stays as the
explicit per-invocation override. Event-server plugins use the
``predictionio_tpu_torch.event_plugins`` group.
"""

from __future__ import annotations

import logging
import os

logger = logging.getLogger(__name__)

ENGINE_GROUP = "predictionio_tpu_torch.plugins"
EVENT_GROUP = "predictionio_tpu_torch.event_plugins"

# PIO_PLUGINS lists BOTH kinds in one env var (the reference's classpath
# is similarly kind-blind, EngineServerPluginContext.scala:34-97 +
# EventServerPluginContext.scala); each server's discovery call keeps the
# entries whose plugin_type belongs to its group
_GROUP_TYPES = {
    ENGINE_GROUP: ("outputblocker", "outputsniffer"),
    EVENT_GROUP: ("inputblocker", "inputsniffer"),
}


def discover_plugins(group: str = ENGINE_GROUP) -> list:
    """Instantiate every plugin advertised for ``group``.

    Sources, in order: installed-package entry points, then the
    ``PIO_PLUGINS`` env var. A plugin that fails to load is logged and
    skipped — one broken package must not take the server down with it
    (the reference's ServiceLoader behaves the same way).
    """
    out = []
    from importlib import metadata

    try:
        eps = metadata.entry_points()
        selected = (
            eps.select(group=group)
            if hasattr(eps, "select")
            else eps.get(group, [])  # pre-3.10 mapping API
        )
        for ep in selected:
            try:
                out.append(ep.load()())
            except Exception:
                logger.exception(
                    "plugin entry point %r (%s) failed to load; skipping",
                    ep.name, group,
                )
    except Exception:
        logger.exception("entry-point scan failed; continuing without")
    group_types = _GROUP_TYPES.get(group)
    if group_types:
        from predictionio_tpu_torch.core.persistence import resolve_class

        seen = {type(p) for p in out}
        for path in (os.environ.get("PIO_PLUGINS") or "").split(","):
            path = path.strip()
            if not path:
                continue
            try:
                cls = resolve_class(path)
            except Exception:
                logger.exception(
                    "PIO_PLUGINS entry %r failed to load; skipping", path
                )
                continue
            # filter on the CLASS attribute before instantiating: the
            # other group's plugin must not run its (possibly
            # side-effectful) __init__ in this server at all
            if getattr(cls, "plugin_type", None) not in group_types:
                logger.debug(
                    "PIO_PLUGINS entry %r is not a %s plugin; skipping "
                    "for this group", path, group,
                )
                continue
            # a plugin advertised BOTH ways (installed entry point + a
            # leftover PIO_PLUGINS entry) — or listed twice in the env
            # var — must run once: dedup BEFORE instantiating so a
            # duplicate's __init__ side effects never fire at all
            if cls in seen:
                continue
            try:
                plugin = cls()
            except Exception:
                logger.exception(
                    "PIO_PLUGINS entry %r failed to load; skipping", path
                )
                continue
            seen.add(cls)
            out.append(plugin)
    return out
