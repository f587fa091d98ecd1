"""Training data of the port: manifests, the on-device scene compositor
and the device batch cache.  Nothing here imports ``cv2``: images come as
arrays, or through a decoder that the caller passes."""
