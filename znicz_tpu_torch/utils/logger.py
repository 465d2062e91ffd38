"""Per-object logging mixin (copy of ``znicz_tpu/utils/logger.py``).

Every port object derives from :class:`Logger` and gets
``debug``/``info``/``warning``/``error`` methods routed through the
stdlib ``logging`` hierarchy under ``znicz_tpu_torch.<ClassName>``.
"""

from __future__ import annotations

import logging


_CONFIGURED = False


def setup_logging(level: int = logging.INFO) -> None:
    """Idempotent package-logger setup with a compact console format."""
    global _CONFIGURED
    if _CONFIGURED:
        logging.getLogger("znicz_tpu_torch").setLevel(level)
        return
    handler = logging.StreamHandler()
    handler.setFormatter(
        logging.Formatter("%(asctime)s %(levelname).1s %(name)s: %(message)s",
                          datefmt="%H:%M:%S"))
    pkg_logger = logging.getLogger("znicz_tpu_torch")
    pkg_logger.addHandler(handler)
    pkg_logger.setLevel(level)
    pkg_logger.propagate = False
    _CONFIGURED = True


class Logger:
    """Mixin: named logger per concrete class."""

    def __init__(self, **kwargs) -> None:
        super().__init__()
        self._logger_ = logging.getLogger(
            f"znicz_tpu_torch.{type(self).__name__}")

    @property
    def logger(self) -> logging.Logger:
        try:
            return self._logger_
        except AttributeError:  # subclass skipped __init__
            self._logger_ = logging.getLogger(
                f"znicz_tpu_torch.{type(self).__name__}")
            return self._logger_

    def debug(self, msg: str, *args) -> None:
        self.logger.debug(msg, *args)

    def info(self, msg: str, *args) -> None:
        self.logger.info(msg, *args)

    def warning(self, msg: str, *args) -> None:
        self.logger.warning(msg, *args)

    def error(self, msg: str, *args) -> None:
        self.logger.error(msg, *args)
