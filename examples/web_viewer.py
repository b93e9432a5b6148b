"""Browser live viewer (integrations/web_viewer.py): MJPEG fly-cam +
clickable HUD over HTTP — the reference's examples/window app for a
headless GPU server (reach it through `ssh -L 8000:127.0.0.1:8000 ...`).

Usage:
  python examples/web_viewer.py [--size 640x360] [--port 8000] [--cpu]
                                [--scene cornell|glb] [--frames N]
"""

try:
    import _path  # noqa: F401  (repo-root sys.path bootstrap)
except ImportError:
    pass

import argparse


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="640x360")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--scene", default="cornell")
    ap.add_argument("--frames", type=int, default=0,
                    help="exit after N frames (0 = run forever)")
    args = ap.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    from sunray_tpu.config import RenderConfig
    from sunray_tpu.integrations.web_viewer import ViewerServer

    w, h = (int(x) for x in args.size.split("x"))
    cfg = RenderConfig(width=w, height=h, lighting="restir",
                       denoise_passes=2)
    scene = None
    if args.scene == "glb":
        from sunray_tpu.scene.gltf import load_gltf

        scene = load_gltf(
            "/root/reference/examples/assets/ReflectionRoom.glb")
    ViewerServer(cfg, scene=scene, host=args.host, port=args.port,
                 max_frames=args.frames).serve()


if __name__ == "__main__":
    main()
