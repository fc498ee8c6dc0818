"""cv2.typing role: public type aliases."""
from typing import Any, Sequence, Tuple, Union

import numpy as np

MatLike = np.ndarray
MatShape = Sequence[int]
Scalar = Union[float, Sequence[float]]
Point = Tuple[int, int]
Point2f = Tuple[float, float]
Point2d = Tuple[float, float]
Point3f = Tuple[float, float, float]
Size = Tuple[int, int]
Rect = Tuple[int, int, int, int]
Rect2d = Tuple[float, float, float, float]
Range = Tuple[int, int]
RotatedRect = Any
TermCriteria = Tuple[int, int, float]
Vec2f = Tuple[float, float]
Vec3f = Tuple[float, float, float]
Vec4f = Tuple[float, float, float, float]
Vec6f = Tuple[float, float, float, float, float, float]
IndexParams = dict
SearchParams = dict
map_string_and_string = dict
map_string_and_int = dict
map_string_and_vector_size_t = dict
map_string_and_vector_float = dict
map_int_and_double = dict
