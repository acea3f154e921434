"""The port's counterparts of the repo's ``mytools/`` scripts that need
the framework (``vis_3d``); ``panoptic2coco`` and ``muco2coco`` import only
numpy, json and the standard library and run as they are."""
