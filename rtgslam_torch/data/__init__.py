from .camera import Camera, CameraInfo, MiniCam, load_camera
from .dataset import Dataset, scene_load_callbacks

__all__ = ["Camera", "CameraInfo", "MiniCam", "load_camera", "Dataset",
           "scene_load_callbacks"]
