"""Interactive viewer and editing session (counterpart of
laenerf_tpu/pipeline/viewer.py; the reference's NeRFGUI, gui.py:21-2106).

  * OrbitCamera: the reference's camera math (gui.py:21-63), numpy only.
  * EditSession: a headless API with the verbs the GUI's buttons call
    (render a frame, click-select, grow, xor/and grids, save them, hand
    them to an EditPipeline), over the port's Trainer on its device.
  * launch_gui: a minimal dearpygui window over EditSession; raises
    unless dearpygui imports.
"""

import numpy as np
import torch

from ..editing import EditGrid
from .driver import EditPipeline, project_points


class OrbitCamera:
    """Orbit camera (gui.py:21-63): radius/theta/phi around a center with
    pan, returning a cam2world pose in the ngp convention."""

    def __init__(self, width=800, height=800, radius=2.0, fovy=50.0):
        self.W, self.H = width, height
        self.radius = radius
        self.fovy = np.radians(fovy)
        self.center = np.zeros(3, np.float32)
        self.rot = np.eye(3, dtype=np.float32)

    @property
    def intrinsics(self):
        focal = self.H / (2 * np.tan(self.fovy / 2))
        return np.array([focal, focal, self.W / 2, self.H / 2], np.float32)

    @property
    def pose(self):
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = self.rot
        pose[:3, 3] = self.center + self.rot @ np.array(
            [0, 0, -self.radius], np.float32)
        return pose

    def orbit(self, dx, dy):
        """Rotate around the up and side axes (gui.py:38-47)."""
        def rotmat(axis, angle):
            axis = axis / (np.linalg.norm(axis) + 1e-8)
            c, s = np.cos(angle), np.sin(angle)
            k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                          [-axis[1], axis[0], 0]])
            return np.eye(3) + s * k + (1 - c) * (k @ k)

        side = self.rot[:, 0]
        up = self.rot[:, 1]
        self.rot = rotmat(up, -0.005 * dx) @ rotmat(side, -0.005 * dy) @ self.rot

    def scale(self, delta):
        self.radius *= 1.1 ** (-delta)

    def pan(self, dx, dy, dz=0.0):
        self.center += 5e-4 * self.rot @ np.array([dx, dy, dz], np.float32)


class EditSession:
    """Headless interactive editing session exposing the GUI's verbs."""

    def __init__(self, trainer, dataset, downscale: int = 1):
        self.trainer = trainer
        self.dataset = dataset
        self.camera = OrbitCamera(dataset.W // downscale,
                                  dataset.H // downscale,
                                  radius=dataset.radius)
        rc = trainer.render_cfg
        self.edit_grid = EditGrid(rc.cascades, rc.grid_size)
        self.negative_grid = EditGrid(rc.cascades, rc.grid_size)
        self.grow_grid = EditGrid(rc.cascades, rc.grid_size)
        self.selected_points = []

    # -- rendering (gui.py render loop / test_gui) ------------------------

    def render_frame(self, downscale: int = 1, show_selection: bool = False):
        """Render the current camera view; with show_selection the edit grid
        replaces the occupancy grid for this frame (renderer.py:267)."""
        cam = self.camera
        H, W = cam.H // downscale, cam.W // downscale
        intr = cam.intrinsics / downscale
        intr[2], intr[3] = W / 2, H / 2
        if show_selection and self.edit_grid.grid is not None:
            occ = self.trainer.occ_state
            backup = occ.occupancy
            try:
                occ.occupancy = torch.as_tensor(
                    self.edit_grid.grid, dtype=torch.uint8,
                    device=self.trainer.device)
                return self.trainer.render_image(cam.pose, intr, H, W)
            finally:
                occ.occupancy = backup
        return self.trainer.render_image(cam.pose, intr, H, W)

    # -- selection (gui.py:562-575, 543-553, 1154-1270) -------------------

    def click_select(self, x: int, y: int, bound=None):
        """Project a clicked pixel to 3D and add it to the selection seed
        set (the GUI's B-key flow). Returns the point."""
        bound = bound or self.trainer.render_cfg.bound
        pts = project_points(self.trainer, self.camera.pose,
                             self.camera.intrinsics, [[x, y]],
                             self.camera.H, self.camera.W)
        self.selected_points.append(pts[0])
        if self.edit_grid.grid is None:
            self.edit_grid.new_from_points(np.array(self.selected_points),
                                           bound=bound)
        else:
            extra = EditGrid(self.edit_grid.cascades,
                             self.edit_grid.grid_size)
            extra.new_from_points(pts, bound=bound)
            self.edit_grid.and_(extra.grid)
            self.edit_grid.growing_queue.extend(extra.growing_queue)
        return pts[0]

    def _density(self, thresh):
        """The density grid on the host and the growing threshold:
        min(mean density, 0.01) unless thresh is given."""
        occ = self.trainer.occ_state
        t = min(float(occ.mean_density), 0.01) if thresh is None else thresh
        return occ.density_grid.cpu().numpy(), t

    def grow(self, iterations: int = 5000, thresh=None):
        density, t = self._density(thresh)
        # clip the selection to occupied space first (gui.py:543-553)
        self.edit_grid.bw_and(self.trainer.occ_state.occupancy.cpu().numpy())
        self.edit_grid.grow_region_queue(density, t,
                                         grow_iterations=iterations)

    def carve_negative(self):
        """Remove the negative grid from the selection (gui.py:1154-1168)."""
        if self.negative_grid.grid is not None:
            self.edit_grid.xor(self.negative_grid.grid)

    def extract_grow_grid(self, thresh=None):
        density, t = self._density(thresh)
        self.grow_grid.grid_from_growing_queue(self.edit_grid, density, t)

    def save_grids(self, edit_path, grow_path=None):
        self.edit_grid.save(edit_path)
        if grow_path and self.grow_grid.grid is not None:
            self.grow_grid.save(grow_path)

    # -- pipeline handoff --------------------------------------------------

    def make_pipeline(self, cfg, workspace):
        return EditPipeline(self.trainer, self.dataset, cfg, workspace,
                            self.edit_grid,
                            self.grow_grid if self.grow_grid.grid is not None
                            else None)


def launch_gui(trainer, dataset):  # pragma: no cover - needs a display
    """Minimal dearpygui frontend over EditSession (reference parity)."""
    try:
        import dearpygui.dearpygui as dpg
    except ImportError as e:
        raise RuntimeError(
            "dearpygui is not installed in this environment; use "
            "EditSession for scripted interaction or the headless pipeline "
            "(python -m laenerf_tpu_torch.pipeline.cli)."
        ) from e

    session = EditSession(trainer, dataset)
    dpg.create_context()
    W, H = session.camera.W, session.camera.H
    img, _ = session.render_frame(downscale=4)
    buf = np.concatenate([img, np.ones_like(img[..., :1])], -1).reshape(-1)
    with dpg.texture_registry():
        dpg.add_raw_texture(W // 4, H // 4, buf, tag="frame",
                            format=dpg.mvFormat_Float_rgba)
    with dpg.window(label="laenerf_tpu_torch", width=W // 4 + 20,
                    height=H // 4 + 60):
        dpg.add_image("frame")
        dpg.add_button(label="grow region", callback=lambda: session.grow())
    dpg.create_viewport(title="laenerf_tpu_torch", width=W // 4 + 40,
                        height=H // 4 + 100)
    dpg.setup_dearpygui()
    dpg.show_viewport()
    while dpg.is_dearpygui_running():
        img, _ = session.render_frame(downscale=4)
        buf[:] = np.concatenate([img, np.ones_like(img[..., :1])],
                                -1).reshape(-1)
        dpg.set_value("frame", buf)
        dpg.render_dearpygui_frame()
    dpg.destroy_context()
