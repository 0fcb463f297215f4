"""Pack a per-object gt database into one resident ``.npy``: counterpart of
``tools/process_tools/create_integrated_database.py``.

    python -m pcp_tpu_torch.tools.create_integrated_database \
        --src_db_info data/kitti/kitti_dbinfos_train.pkl --root_path data/kitti \
        --new_db_name kitti_dbinfos_train_global

Reads a ``*_dbinfos_*.pkl``, concatenates every object's ``.bin`` rows into
``{root_path}/{new_db_name}.npy`` and stamps ``global_data_offset`` ranges
back into the pkl; ``DataBaseSampler`` slices the array when the sampler
config names it in ``DB_DATA_PATH``.
"""
import argparse

from ..datasets.augmentor.gt_database import create_integrated_database


def main(argv=None):
    parser = argparse.ArgumentParser(description="pack a gt database into one .npy")
    parser.add_argument("--src_db_info", type=str, required=True,
                        help="the *_dbinfos_*.pkl that create_groundtruth_database wrote")
    parser.add_argument("--root_path", type=str, required=True,
                        help="dataset root the db-info 'path' entries are relative to")
    parser.add_argument("--new_db_name", type=str, required=True,
                        help="output npy name (without extension), written under root_path")
    parser.add_argument("--num_point_features", type=int, default=4)
    args = parser.parse_args(argv)
    return create_integrated_database(args.src_db_info, args.root_path, args.new_db_name,
                                      args.num_point_features)


if __name__ == "__main__":
    main()
