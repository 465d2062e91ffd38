"""The interactive shell unit (port of ``znicz_tpu/interaction.py``).

:class:`Shell` drops the run into an interactive Python console when it
fires, so the user can look at and change the live workflow between
steps, then resume by leaving the console.  IPython is used where it
imports, the standard library's ``code.interact`` otherwise.  It is a
host unit: it fires after the decision, outside the training step's
graph.

Wire it like any side unit, once an epoch (``StandardWorkflow.link_shell``
does so)::

    shell = Shell(wf)
    shell.link_from(wf.decision)
    shell.gate_skip = Bool._derived(lambda: not wf.decision.epoch_ended)
"""

from __future__ import annotations

from znicz_tpu_torch.units import Unit


class Shell(Unit):
    """Drop into an interactive console when fired.

    The namespace exposes ``workflow``, ``shell`` (this unit) and
    everything in ``extra_locals``.  Set ``shell.enabled = False``
    from inside the console to stop future firings.
    """

    def __init__(self, workflow, name: str | None = None,
                 banner: str | None = None,
                 extra_locals: dict | None = None,
                 interact_fn=None, **kwargs) -> None:
        super().__init__(workflow, name=name, **kwargs)
        self.enabled = True
        self.banner = banner
        self.extra_locals = dict(extra_locals or {})
        #: the console (a test or an embedding caller injects its own);
        #: IPython or code.interact by default
        self._interact_fn = interact_fn

    def _default_interact(self, banner: str, local: dict) -> None:
        try:  # pragma: no cover - depends on IPython presence
            from IPython import embed
            embed(banner1=banner, user_ns=local,
                  colors="neutral")
            return
        except ImportError:
            pass
        import code
        code.interact(banner=banner, local=local)

    def run(self) -> None:
        if not self.enabled:
            return
        wf = self.workflow
        local = {"workflow": wf, "shell": self}
        if wf is not None:
            for attr in ("loader", "decision", "evaluator", "forwards",
                         "gds"):
                value = getattr(wf, attr, None)
                if value is not None:
                    local[attr] = value
        local.update(self.extra_locals)
        banner = self.banner or (
            f"znicz_tpu_torch shell — workflow "
            f"'{wf.name if wf else '?'}' paused; locals: "
            f"{', '.join(sorted(local))}.  Exit to resume; "
            f"shell.enabled=False to stop appearing.")
        interact = self._interact_fn or self._default_interact
        interact(banner, local)
