"""Benchmark semantic class vocabularies (the port's own copy of the JAX
package's ``evaluation/labels.py``), used by the single-object evaluator
for per-class grouping and the wall/floor/ceiling exclusion option.
"""

DATASET_CLASSES = {
    "scannet40": {
        "wall", "floor", "cabinet", "bed", "chair", "sofa", "table", "door",
        "window", "bookshelf", "picture", "counter", "blinds", "desk",
        "shelves", "curtain", "dresser", "pillow", "mirror", "floormat",
        "clothes", "ceiling", "books", "refridgerator", "television", "paper",
        "towel", "showercurtain", "box", "whiteboard", "person", "nightstand",
        "toilet", "sink", "lamp", "bathtub", "bag", "otherstructure",
        "otherfurniture", "otherprop",
    },
    "s3dis": {
        "ceiling", "floor", "wall", "beam", "column", "window", "door",
        "table", "chair", "sofa", "bookcase", "board", "clutter",
    },
    "kitti360": {
        "17", "19", "20", "24", "26", "27", "29", "30", "32", "33", "34",
        "36", "37", "38", "39", "40", "41",
    },
}
