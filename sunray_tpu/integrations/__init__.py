"""Host-app integrations — the analog of the reference's L7 layer.

The reference integrates via a winit window fly-cam app
(examples/window/main.rs) and a Bevy engine plugin
(src/bevy_integration/plugin.rs). A GPU server is headless, so the
integration points here are:

- `EngineAdapter` (engine.py): the per-tick extract contract the Bevy
  plugin implements (camera + instance list in, frame out).
- `LiveViewer` (viewer.py): an HTTP live viewer with a browser fly-cam —
  the interactive `window` example analog (swapchain-present becomes an
  MJPEG/poll stream to the browser).
"""

from sunray_tpu.integrations.engine import EngineAdapter, FlyCamera
from sunray_tpu.integrations.viewer import LiveViewer

__all__ = ["EngineAdapter", "FlyCamera", "LiveViewer"]
