from .timers import PhaseTimer
from .palette import palette_to_img, palette_change_to_img
from .images import write_png
from .color import srgb_to_linear, linear_to_srgb
from .video import write_video
from .plots import plot_losses
