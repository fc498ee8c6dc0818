"""cv2.data role: asset directory paths (we ship no Haar xml data
files; train or supply your own — ops/cascade.py loads JSON
cascades)."""
import os

haarcascades = os.path.join(os.path.dirname(__file__), '') 
