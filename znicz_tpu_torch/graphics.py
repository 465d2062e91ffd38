"""Graphics service: decoupled rendering and the metrics event stream
(port of ``znicz_tpu/graphics.py``).

The reference's plotting transport, kept as it is:

- plotter units :meth:`GraphicsServer.submit` small *payload dicts*;
- a background **render thread** draws them with matplotlib's
  thread-safe object API (``Figure`` + Agg canvas, no pyplot) into
  ``root.common.dirs.plots``, so the training loop never blocks on
  drawing; a burst of payloads of one name draws only the newest;
- every payload is also appended to ``events.jsonl`` (arrays
  summarized by :func:`_summarize`), the structured metrics stream;
- optionally the payload is ZeroMQ-PUB-published (pickled) for a live
  :class:`GraphicsClient`.

A payload reaches the server as host data: the plotters read device
tensors back to numpy after the training step's graph has run
(:mod:`znicz_tpu_torch.plotting_units`), so nothing here touches the
card.  matplotlib is imported by the render thread and pyzmq by a
server with a publish port, so a machine without them runs with
``render=False`` (``--no-graphics``) and no port.  A draw that fails is
logged and rendering goes on (the ``multi_hist`` payload of
:class:`~znicz_tpu_torch.ops.aux_units.MultiHistogram` is such a one in
both packages: it is logged to ``events.jsonl`` and draws no PNG).

Payload schema (all optional but ``kind``/``name``):
``{"kind": "curve"|"matrix"|"image"|"hist", "name": str, "step": int,
"series": {label: [[x...],[y...]]}, "data": ndarray, "labels": [...]}``
"""

from __future__ import annotations

import json
import os
import pickle
import queue
import threading

import numpy as np

from znicz_tpu_torch.utils.config import root
from znicz_tpu_torch.utils.logger import Logger


def _summarize(value):
    """JSON-safe summary of a payload value (arrays → stats, not bulk)."""
    if isinstance(value, np.ndarray):
        if value.size <= 64:
            return value.tolist()
        return {"shape": list(value.shape),
                "min": float(value.min()), "max": float(value.max()),
                "mean": float(value.mean())}
    if isinstance(value, dict):
        return {k: _summarize(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        if len(value) > 256:
            return {"len": len(value), "tail": _summarize(value[-4:])}
        return [_summarize(v) for v in value]
    if isinstance(value, (np.integer,)):
        return int(value)
    if isinstance(value, (np.floating,)):
        return float(value)
    return value


class GraphicsServer(Logger):
    """Collects plot payloads; renders + logs + publishes off-thread."""

    def __init__(self, out_dir: str | None = None,
                 render: bool | None = None,
                 publish_port: "int | bool | None" = None) -> None:
        # publish_port: None → config default; False → never publish
        super().__init__()
        self.out_dir = out_dir or str(root.common.dirs.plots)
        os.makedirs(self.out_dir, exist_ok=True)
        self.render = (bool(root.common.graphics.render)
                       if render is None else render)
        self._events_path = os.path.join(self.out_dir, "events.jsonl")
        self._events_lock = threading.Lock()
        self._queue: "queue.Queue[dict | None]" = queue.Queue()
        self._thread: threading.Thread | None = None
        self._pub = None
        port = (publish_port if publish_port is not None
                else root.common.graphics.publish_port)
        self.publish_port = None
        if port is not None and port is not False:
            import zmq
            self._zmq_ctx = zmq.Context.instance()
            self._pub = self._zmq_ctx.socket(zmq.PUB)
            if int(port) == 0:  # pick a free port
                self.publish_port = self._pub.bind_to_random_port(
                    "tcp://127.0.0.1")
            else:
                self.publish_port = int(port)
                self._pub.bind(f"tcp://*:{self.publish_port}")
            self.endpoint = f"tcp://127.0.0.1:{self.publish_port}"
        if self.render:
            self._thread = threading.Thread(
                target=self._render_loop, name="graphics-render",
                daemon=True)
            self._thread.start()

    # ------------------------------------------------------------------
    def submit(self, payload: dict) -> None:
        """Accept a payload from a plotter unit (cheap, non-blocking)."""
        self._log_event(payload)
        if self._pub is not None:
            topic = payload.get("name", "plot").encode()
            self._pub.send_multipart([topic, pickle.dumps(payload)])
        if self._thread is not None:
            self._queue.put(payload)

    def flush(self, timeout: float = 30.0) -> bool:
        """Block until everything submitted so far has been drawn
        (consumers like the Publisher embed the PNGs — they must not
        read files the render thread is still writing)."""
        if self._thread is None:
            return True
        event = threading.Event()
        self._queue.put({"__flush__": event})
        return event.wait(timeout)

    def stop(self) -> None:
        """Drain the render queue and join the thread."""
        if self._thread is not None:
            self._queue.put(None)
            self._thread.join(timeout=30)
            self._thread = None
        if self._pub is not None:
            self._pub.close(linger=0)
            self._pub = None

    # ------------------------------------------------------------------
    def _log_event(self, payload: dict) -> None:
        event = {k: _summarize(v) for k, v in payload.items()}
        line = json.dumps(event)
        with self._events_lock:
            with open(self._events_path, "a") as f:
                f.write(line + "\n")

    def _render_loop(self) -> None:
        while True:
            payload = self._queue.get()
            if payload is None:
                return
            # collapse bursts: only the newest payload per name is drawn
            latest: dict[str, dict] = {}
            flush_events = []
            stopping = False
            if "__flush__" in payload:
                flush_events.append(payload["__flush__"])
            else:
                latest[payload.get("name", "plot")] = payload
            try:
                while not stopping:
                    extra = self._queue.get_nowait()
                    if extra is None:
                        stopping = True
                    elif "__flush__" in extra:
                        flush_events.append(extra["__flush__"])
                    else:
                        latest[extra.get("name", "plot")] = extra
            except queue.Empty:
                pass
            for p in latest.values():
                try:
                    self._draw(p)
                except Exception as exc:  # noqa: BLE001 — keep rendering
                    self.warning("failed to draw %s: %s",
                                 p.get("name"), exc)
            for event in flush_events:
                event.set()
            if stopping:
                return

    # -- drawing (render thread only) -----------------------------------
    def _draw(self, payload: dict) -> None:
        from matplotlib.backends.backend_agg import FigureCanvasAgg
        from matplotlib.figure import Figure

        kind = payload.get("kind", "curve")
        name = payload.get("name", "plot")
        fig = Figure(figsize=(6.4, 4.8), dpi=100)
        FigureCanvasAgg(fig)
        ax = fig.add_subplot(111)
        if kind == "curve":
            for label, (xs, ys) in payload.get("series", {}).items():
                ax.plot(xs, ys, label=label)
            ax.set_xlabel(payload.get("xlabel", "epoch"))
            ax.set_ylabel(payload.get("ylabel", ""))
            if payload.get("series"):
                ax.legend(loc="best", fontsize=8)
            ax.grid(True, alpha=0.3)
        elif kind == "matrix":
            data = np.asarray(payload["data"])
            im = ax.imshow(data, cmap=payload.get("cmap", "viridis"))
            fig.colorbar(im, ax=ax)
            labels = payload.get("labels")
            if labels is not None and len(labels) <= 32:
                ax.set_xticks(range(len(labels)), labels, fontsize=6,
                              rotation=90)
                ax.set_yticks(range(len(labels)), labels, fontsize=6)
            if data.shape[0] * data.shape[1] <= 400:
                for (i, j), v in np.ndenumerate(data):
                    ax.text(j, i, f"{v:g}", ha="center", va="center",
                            fontsize=6)
        elif kind == "image":
            data = np.asarray(payload["data"])
            ax.imshow(data, cmap=payload.get("cmap", "gray"))
            ax.axis("off")
        elif kind == "hist":
            data = np.asarray(payload["data"]).ravel()
            ax.bar(np.asarray(payload.get(
                "bin_centers", np.arange(data.size))), data,
                width=payload.get("bar_width", 0.8))
            ax.set_ylabel(payload.get("ylabel", "count"))
        else:
            raise ValueError(f"unknown payload kind '{kind}'")
        title = payload.get("title", name)
        step = payload.get("step")
        if step is not None:
            title = f"{title}  [{payload.get('xlabel', 'epoch')} {step}]"
        ax.set_title(title, fontsize=10)
        fig.tight_layout()
        fig.savefig(os.path.join(self.out_dir, f"{name}.png"))


class GraphicsClient(Logger):
    """Subscribes to a :class:`GraphicsServer`'s PUB socket and renders
    received payloads locally (reference: the separate
    ``graphics_client`` matplotlib process)."""

    def __init__(self, endpoint: str, out_dir: str) -> None:
        super().__init__()
        import zmq
        self._ctx = zmq.Context.instance()
        self._sub = self._ctx.socket(zmq.SUB)
        self._sub.connect(endpoint)
        self._sub.setsockopt(zmq.SUBSCRIBE, b"")
        # publish_port=False: the internal renderer must never open its
        # own PUB socket (it would race the real server for the
        # configured port)
        self._renderer = GraphicsServer(out_dir=out_dir, render=False,
                                        publish_port=False)

    def poll_once(self, timeout_ms: int = 1000) -> bool:
        """Receive and draw one payload; False on timeout."""
        import zmq
        if not self._sub.poll(timeout_ms, zmq.POLLIN):
            return False
        _topic, blob = self._sub.recv_multipart()
        self._renderer._draw(pickle.loads(blob))
        return True

    def close(self) -> None:
        self._sub.close(linger=0)


# ----------------------------------------------------------------------
# process-global default server (reference: one GraphicsServer per run)
# ----------------------------------------------------------------------
_server: GraphicsServer | None = None
_server_lock = threading.Lock()


def get_server() -> GraphicsServer:
    global _server
    with _server_lock:
        if _server is None:
            _server = GraphicsServer()
        return _server


def flush_server() -> bool:
    """Flush the global server's render queue IF one exists (never
    creates one).  False = flush timed out, renders may be mid-write."""
    with _server_lock:
        server = _server
    if server is not None:
        return server.flush()
    return True


def reset_server() -> None:
    """Stop and drop the global server (tests / run teardown)."""
    global _server
    with _server_lock:
        if _server is not None:
            _server.stop()
            _server = None
