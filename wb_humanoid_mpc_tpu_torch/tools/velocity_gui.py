"""Operator velocity GUI: Tk virtual joysticks -> CommandBus.

PyTorch-port counterpart of `wb_humanoid_mpc_tpu/tools/velocity_gui.py`.

The launch CLI's analogue of the reference's `base_velocity_controller_gui`
(`remote_control/remote_control/base_velocity_controller_gui.py`, entry point
`remote_control/setup.py:24-25`): two virtual joysticks (left: vx/vy, right:
yaw rate with a fixed y-axis), a pelvis-height slider, an auto-center toggle,
and an xbox-connected LED. Instead of publishing a DDS
`WalkingVelocityCommand` topic at 25 Hz, the GUI writes the same 4-field
command into the in-process `CommandBus` the MPC loop polls each solve
(`tools/commands.py`); when an `XboxCommandSource` is attached, physical
joystick input overrides the virtual knobs and the knobs follow it, exactly
like the reference GUI mirroring the xbox state.

Pure stdlib tkinter — import-gated so headless environments (no $DISPLAY, no
Tk build) degrade gracefully: `launch_velocity_gui` returns False instead of
raising.
"""

from __future__ import annotations

import threading

from wb_humanoid_mpc_tpu_torch.tools.commands import CommandBus, WalkingVelocityCommand


class VirtualJoystick:
    """Draggable knob on a square canvas; normalized (x, y) in [-1, 1]
    (reference `tk_app/joystick_gui.py:34-149`)."""

    SIZE = 180
    KNOB_R = 18

    def __init__(self, tk, parent, label: str, fix_x: bool = False,
                 auto_center: bool = True):
        self._tk = tk
        self.frame = tk.Frame(parent, bg="#2c2c2c")
        tk.Label(self.frame, text=label, fg="#eeeeee", bg="#2c2c2c").pack()
        self.canvas = tk.Canvas(self.frame, width=self.SIZE, height=self.SIZE,
                                bg="#1e1e1e", highlightthickness=0)
        self.canvas.pack(padx=8, pady=4)
        self.fix_x = fix_x
        self.auto_center = auto_center
        c = self.SIZE // 2
        self.canvas.create_oval(6, 6, self.SIZE - 6, self.SIZE - 6,
                                outline="#555555")
        self.knob = self.canvas.create_oval(
            c - self.KNOB_R, c - self.KNOB_R, c + self.KNOB_R, c + self.KNOB_R,
            fill="#4a90d9", outline="")
        self.x_norm = 0.0
        self.y_norm = 0.0
        self.canvas.bind("<B1-Motion>", self._drag)
        self.canvas.bind("<ButtonRelease-1>", self._release)

    def _drag(self, event) -> None:
        c = self.SIZE / 2
        span = c - self.KNOB_R - 6
        x = 0.0 if self.fix_x else max(-1.0, min(1.0, (event.x - c) / span))
        y = max(-1.0, min(1.0, (c - event.y) / span))
        self.set_position(x, y)

    def _release(self, _event) -> None:
        if self.auto_center:
            self.set_position(0.0, 0.0)

    def set_position(self, x_norm: float, y_norm: float) -> None:
        self.x_norm, self.y_norm = x_norm, y_norm
        c = self.SIZE / 2
        span = c - self.KNOB_R - 6
        px = c + x_norm * span
        py = c - y_norm * span
        self.canvas.coords(self.knob, px - self.KNOB_R, py - self.KNOB_R,
                           px + self.KNOB_R, py + self.KNOB_R)


class VelocityGui:
    """The assembled controller window (reference `App`,
    `base_velocity_controller_gui.py:41-220`)."""

    PUBLISH_HZ = 25  # reference publisher_rate

    def __init__(self, bus: CommandBus, xbox_source=None):
        import tkinter as tk

        self.bus = bus
        self.xbox = xbox_source
        self.root = tk.Tk()
        self.root.title("Robot Base Controller")
        self.root.configure(bg="#2c2c2c")

        row = tk.Frame(self.root, bg="#2c2c2c")
        row.pack(padx=12, pady=12)
        # left stick: y -> vx, x -> vy (reference joystick mapping)
        self.left = VirtualJoystick(tk, row, "translation (vx/vy)")
        self.left.frame.pack(side="left")
        # height slider
        mid = tk.Frame(row, bg="#2c2c2c")
        mid.pack(side="left", padx=10)
        tk.Label(mid, text="pelvis dz [m]", fg="#eeeeee", bg="#2c2c2c").pack()
        self.height = tk.Scale(mid, from_=0.3, to=-0.3, resolution=0.01,
                               orient="vertical", length=150, bg="#2c2c2c",
                               fg="#eeeeee", highlightthickness=0)
        self.height.set(0.0)
        self.height.pack()
        # right stick: x -> yaw rate (y axis fixed)
        self.right = VirtualJoystick(tk, row, "yaw rate", fix_x=False)
        self.right.fix_x = False
        self.right.frame.pack(side="left")

        bottom = tk.Frame(self.root, bg="#2c2c2c")
        bottom.pack(pady=(0, 10))
        self.auto_center_var = tk.BooleanVar(value=True)
        tk.Checkbutton(bottom, text="auto-center", variable=self.auto_center_var,
                       command=self._toggle_auto_center, bg="#2c2c2c",
                       fg="#eeeeee", selectcolor="#1e1e1e").pack(side="left", padx=6)
        tk.Button(bottom, text="STOP", command=self._stop_cmd,
                  bg="#d94a4a", fg="white").pack(side="left", padx=6)
        # xbox LED (reference LEDIndicatorGui)
        self.led = tk.Canvas(bottom, width=16, height=16, bg="#2c2c2c",
                             highlightthickness=0)
        self._led_dot = self.led.create_oval(2, 2, 14, 14, fill="#777777")
        self.led.pack(side="left", padx=6)
        tk.Label(bottom, text="xbox", fg="#eeeeee", bg="#2c2c2c").pack(side="left")

        self.root.after(int(1000 / self.PUBLISH_HZ), self._tick)

    def _toggle_auto_center(self) -> None:
        ac = bool(self.auto_center_var.get())
        self.left.auto_center = ac
        self.right.auto_center = ac
        if ac:
            self.left.set_position(0.0, 0.0)
            self.right.set_position(0.0, 0.0)

    def _stop_cmd(self) -> None:
        self.left.set_position(0.0, 0.0)
        self.right.set_position(0.0, 0.0)
        self.height.set(0.0)
        self.bus.set_velocity(WalkingVelocityCommand())

    def _tick(self) -> None:
        # physical joystick overrides and mirrors (reference timer_callback)
        if self.xbox is not None and getattr(self.xbox, "connected", False):
            self.led.itemconfigure(self._led_dot, fill="#4ad96a")
            cmd = self.bus.get_velocity()
            self.left.set_position(-float(cmd[1]), float(cmd[0]))
            self.right.set_position(float(cmd[3]), 0.0)
        else:
            if self.xbox is not None:
                self.led.itemconfigure(self._led_dot, fill="#777777")
            self.bus.set_velocity(WalkingVelocityCommand(
                linear_velocity_x=self.left.y_norm,
                linear_velocity_y=-self.left.x_norm,
                desired_pelvis_height=float(self.height.get()),
                angular_velocity_z=-self.right.x_norm,
            ))
        self.root.after(int(1000 / self.PUBLISH_HZ), self._tick)

    def run_in_thread(self) -> threading.Thread:
        t = threading.Thread(target=self.root.mainloop, daemon=True,
                             name="velocity-gui")
        t.start()
        return t


def launch_velocity_gui(bus: CommandBus, xbox_source=None, block: bool = False):
    """Start the GUI; returns the VelocityGui, or None when Tk/$DISPLAY is
    unavailable (headless)."""
    try:
        gui = VelocityGui(bus, xbox_source)
    except Exception as e:  # noqa: BLE001 — TclError has env-specific types
        import sys

        print(f"[velocity-gui] unavailable ({e}); falling back to keyboard "
              f"commands", file=sys.stderr)
        return None
    if block:
        gui.root.mainloop()
    else:
        gui.run_in_thread()
    return gui
