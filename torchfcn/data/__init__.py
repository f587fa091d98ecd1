"""Training data of the port: manifests, the VOC converter, record shards,
the on-device scene compositor and the batch sources.  Nothing here imports
``cv2``: images are decoded by the port's own JPEG and PNG readers
(``jpeg``, ``imageio``), or come as arrays, or through a decoder that the
caller passes."""
